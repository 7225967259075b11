"""The parallel layer on ``torch.distributed`` (counterpart of
proteingym_tpu/parallel): meshes and sharding plans (``mesh``) and the
multi-process dry run on the CPU (``dryrun``)."""
