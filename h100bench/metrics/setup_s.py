"""Seconds from the process's start to the window's: interpreter and torch
start, the kernel library built or loaded, weights drawn on the device and
loaded through the port's loader, and the warm-up of the cell's shapes."""


def read(r):
    return r.setup_s
