"""The multi-process dry run of the parallel layer on the CPU (counterpart
of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``, which
runs the same checks on a virtual CPU mesh).

``dryrun_multichip(n)`` spawns n worker processes (this module with
``--worker``), each on one torch thread, joined in a gloo process group
through a ``FileStore`` in a temporary directory, under a hard deadline
(each worker's alarm fires first; then the parent kills every worker's
process group). The workers run, on tiny seeded models:

- the TP x DP ESM training step on a (data = n / 2, model = 2) mesh, on a
  batch the data axis does not divide, against the same step in one
  process: the loss and every parameter shard;
- the expert-parallel ProGen3 forward (experts over all n ranks) against
  the unsharded forward;
- ring attention with the sequence over all n ranks, some keys masked,
  against dense attention;
- ``score --mesh data=n/2,model=2`` through the CLI (chunks of 5 rows, which
  the data axis does not divide), against the single-process scorer, and
  only rank 0 writing the CSV, the manifest and the event log;
- packed cross-assay scoring through the sharded model against
  single-process packed scoring;
- a mesh larger than the world, and an unknown axis, raising.

Rank 0 prints one ``DRYRUN {json}`` line; the parent checks each number
against its tolerance (float32 sums in other orders) and returns them,
with the sharded runs' inputs (``*_in``) and outputs (``*_out``): the
training batch and its masks, the MoE tokens and logits, the ring output,
the assays and their ``--mesh`` and packed x TP scores. The weights are
``esm_state()`` (one ``esm2_tiny`` state dict for the training step, the
``--mesh`` CLI run through a checkpoint file, and packed x TP) and
``moe_config(n)``'s ``init_random`` from ``MOE_SEED``, so a caller
rebuilds the same weights to hold these outputs against another
implementation.

    python -m proteingym_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np

# each reading's tolerance: float32 on both sides, sums in other orders
# (the gradients relative to each tensor's largest; an AdamW first step
# moves an entry by lr g / (|g| + eps), so an entry whose gradient is near
# eps = 1e-8 moves by a different share of lr = 1e-4 when its sum's order
# changes: 8.5e-6 on the CPU here)
TOLERANCES = {"train_loss": 1e-5, "train_grads": 1e-5, "train_params": 2e-5, "moe": 1e-5, "ring": 1e-5,
              "mesh_scores": 1e-5, "packed": 1e-5}
_REPO = Path(__file__).resolve().parents[2]
ESM_SEED, MOE_SEED = 0, 2


def esm_state():
    """The dry run's ESM weights, a fair-esm state dict of ``esm2_tiny``:
    the preset's ``init_random`` from ``ESM_SEED`` with every bias drawn
    N(0, 0.1^2) as well (the preset's are 0, which would hide where a
    row-parallel layer adds its bias)."""
    import torch

    from proteingym_tpu_torch.models import esm2

    model = esm2.init_random(esm2.PRESETS["esm2_tiny"], seed=ESM_SEED, device="cpu")
    gen = torch.Generator().manual_seed(ESM_SEED + 1)
    return {name: value + 0.1 * torch.randn(value.shape, generator=gen)
            if name.endswith(".bias") else value.clone()
            for name, value in model.state_dict().items()}


def moe_config(world: int):
    """The ProGen3 config of the expert-parallel forward on ``world`` ranks
    (``init_random`` from ``MOE_SEED``): one expert a rank, at least two."""
    import torch

    from proteingym_tpu_torch.models import progen3

    return progen3.ProGen3Config("dryrun_moe", 2, 64, 4, None, 96, num_experts=max(world, 2),
                                 top_k=2, dtype=torch.float32)


def dryrun_multichip(n: int = 4, timeout: float = 300.0) -> Dict:
    """Run the checks on ``n`` gloo processes (n even for the TP x DP
    mesh); raise if a worker fails, the deadline passes, or a reading is
    out of tolerance. Returns rank 0's readings."""
    workdir = Path(tempfile.mkdtemp(prefix="pgym_dryrun_"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
        "PGYM_DRYRUN_DEADLINE": str(max(int(timeout) - 15, 30))}
    procs, logs = [], []
    try:
        for rank in range(n):
            log = open(workdir / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "proteingym_tpu_torch.parallel.dryrun", "--worker",
                 str(rank), str(n), str(workdir)],
                env=env, cwd=str(workdir), stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
        end = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun workers timed out after {timeout:.0f} s:\n"
                               + _tails(workdir, n))
        finally:
            for p in procs:
                if p.poll() is None:
                    try:
                        os.killpg(p.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    p.wait()
        for log in logs:
            log.close()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("dryrun worker(s) failed (rc "
                               f"{[p.returncode for p in procs]}):\n" + _tails(workdir, n))
        lines = [line for line in (workdir / "rank0.log").read_text().splitlines()
                 if line.startswith("DRYRUN ")]
        if not lines:
            raise RuntimeError("rank 0 printed no result:\n" + _tails(workdir, n))
        result = json.loads(lines[-1][len("DRYRUN "):])
    finally:
        for log in logs:
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)
    for key, tol in TOLERANCES.items():
        if not result[key] <= tol:
            raise RuntimeError(f"dryrun {key}: {result[key]} beyond {tol}")
    for key in ("only_rank0_wrote", "too_small_raises", "unknown_axis_raises"):
        if not result[key]:
            raise RuntimeError(f"dryrun check {key} failed")
    if not np.isfinite(result["train_loss_value"]):
        raise RuntimeError(f"non-finite loss {result['train_loss_value']}")
    return result


def _tails(workdir: Path, n: int) -> str:
    out = []
    for rank in range(n):
        path = workdir / f"rank{rank}.log"
        text = path.read_text() if path.exists() else ""
        out.append(f"--- rank {rank} ---\n{text[-3000:]}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    deadline = int(os.environ.get("PGYM_DRYRUN_DEADLINE", "285"))

    def expired(signum, frame):  # pragma: no cover
        raise TimeoutError(f"dryrun worker exceeded its {deadline} s deadline")

    signal.signal(signal.SIGALRM, expired)
    signal.alarm(deadline)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        readings = _checks(rank, world, workdir)
        worst = torch.tensor([readings[k] for k in TOLERANCES], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        readings.update({k: float(v) for k, v in zip(TOLERANCES, worst)})
        if rank == 0:
            print("DRYRUN " + json.dumps(readings), flush=True)
    finally:
        signal.alarm(0)
        dist.destroy_process_group()


def _max_diff(a, b) -> float:
    import torch

    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def _checks(rank: int, world: int, workdir: Path) -> Dict:
    import torch
    import torch.distributed as dist

    from proteingym_tpu_torch.data.mutants import apply_mutant
    from proteingym_tpu_torch.models import esm2, progen3
    from proteingym_tpu_torch.models.esm_scoring import score_assay
    from proteingym_tpu_torch.models.esm_train import make_train_step, mask_batch
    from proteingym_tpu_torch.models.packed_scoring import score_assays_packed
    from proteingym_tpu_torch.ops.flash_attention import reference_mha
    from proteingym_tpu_torch.ops.ring_attention import ring_attention
    from proteingym_tpu_torch.parallel.mesh import (
        default_mesh, esm_param_sharding, make_mesh, mesh_from_spec, replicate, shard_params,
    )
    from proteingym_tpu_torch.pipeline import cli
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    out: Dict = {}
    model_axis = 2 if world % 2 == 0 else 1
    data_axis = world // model_axis
    mesh = make_mesh(data=data_axis, model=model_axis, device="cpu")
    out["mesh"] = f"data={data_axis},model={model_axis}"
    flat = default_mesh(device="cpu")
    out["default_mesh"] = f"data={flat.data},model={flat.model}"

    # TP x DP training step against the single-process step
    state, config = esm_state(), esm2.PRESETS["esm2_tiny"]
    model = esm2.load_fair_esm_state_dict(state, config, device="cpu")
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEV"
    tokens = torch.as_tensor(np.stack([esm2.ALPHABET.tokenize(seq[:20 + 3 * i], pad_to=40)
                                       for i in range(2 * data_axis + 1)]), dtype=torch.long)
    # each rank draws its own sequence weights; rank 0's reach every rank
    weights = torch.rand(tokens.shape[0], generator=torch.Generator().manual_seed(rank)) + 0.5
    replicate([weights], mesh)
    masked = mask_batch(torch.Generator().manual_seed(1), tokens)
    init, step = make_train_step(config)
    single = init(model)
    loss_single = step(single, tokens, weights, masked=masked)
    sharded = init(model, mesh)
    loss_tp = step(sharded, tokens, weights, masked=masked)
    # ShardedEsm splits the layers by the plan and holds the rest whole
    plan = {k: d if k.startswith("layers.") else None
            for k, d in esm_param_sharding(model, mesh).items()}
    want = shard_params({k: v.detach() for k, v in single.model.state_dict().items()},
                        plan, mesh)
    got = sharded.model.state_dict()
    out["train_params"] = max(_max_diff(got[k], want[k]) for k in got)
    grads = shard_params({k: p.grad for k, p in single.model.named_parameters()}, plan, mesh)
    out["train_grads"] = max(_max_diff(p.grad, grads[k]) / float(grads[k].abs().max())
                             for k, p in sharded.model.named_parameters())
    out["train_loss"] = _max_diff(loss_tp, loss_single)
    out["train_loss_value"] = float(loss_tp)
    out["train_in"] = dict(tokens=tokens.tolist(), masked=masked[0].tolist(),
                           target_mask=masked[1].tolist(), weights=weights.tolist())

    # expert-parallel MoE forward over every rank
    moe = progen3.init_random(moe_config(world), seed=MOE_SEED, device="cpu")
    toks = torch.as_tensor(np.random.RandomState(0).randint(0, 30, (2, 12)), dtype=torch.long)
    with torch.no_grad():
        dense = moe(toks)
        sharded_logits = progen3.expert_sharded_apply(moe, toks)
    out["moe"] = _max_diff(sharded_logits, dense)
    out["moe_in"], out["moe_out"] = toks.tolist(), sharded_logits.tolist()

    # ring attention over every rank against dense attention
    rs = np.random.RandomState(1)
    b, h, t, d = 1, 2, 8 * world, 8
    q, k, v = (torch.as_tensor(rs.randn(b, h, t, d), dtype=torch.float32) for _ in range(3))
    key_mask = torch.ones(b, t, dtype=torch.bool)
    key_mask[:, -3:] = False
    ring = ring_attention(q, k, v, key_mask=key_mask)
    out["ring"] = _max_diff(ring, reference_mha(q, k, v, key_mask=key_mask, sm_scale=d ** -0.5))
    out["ring_out"] = ring.tolist()

    # score --mesh through the CLI, chunks of 5 rows over the data axis
    target = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQ"
    rs2, aa = np.random.RandomState(7), "ACDEFGHIKLMNPQRSTVWY"
    mutants = []
    for p in rs2.randint(0, len(target), 10):
        mt = aa[(aa.index(target[p]) + 1 + rs2.randint(19)) % 20]  # never the WT letter
        mutants.append(f"{target[p]}{p + 1}{mt}")
    root = workdir / "world"
    checkpoint = f"esm2_tiny:{root / 'esm2_tiny.pt'}"
    if rank == 0:
        (root / "dms").mkdir(parents=True)
        torch.save(state, root / "esm2_tiny.pt")
        (root / "ref.csv").write_text(
            f"DMS_id,DMS_filename,target_seq\nDRYRUN,DRYRUN.csv,{target}\n")
        (root / "dms" / "DRYRUN.csv").write_text(
            "mutant,mutated_sequence\n"
            + "".join(f"{m},{apply_mutant(target, m)}\n" for m in mutants))
    dist.barrier()
    rc = cli.main(["score", "--model", "esm", "--checkpoint", checkpoint, "--device", "cpu",
                   "--dms-reference", str(root / "ref.csv"), "--dms-dir", str(root / "dms"),
                   "--output-dir", str(root / "out"), "--batch-size", "5", "--quiet",
                   "--mesh", out["mesh"]])
    dist.barrier()
    tiny, _ = load_esm_checkpoint(checkpoint, device="cpu")
    single_scores = score_assay(tiny, target, mutants, chunk=5, window=tiny.config.max_positions)
    with open(root / "out" / "DRYRUN.csv") as f:
        rows = f.read().splitlines()
    column = rows[0].split(",").index("esm2_tiny_score")
    got_scores = np.asarray([float(r.split(",")[column]) for r in rows[1:]])
    out["mesh_scores"] = _max_diff(got_scores, single_scores) if rc == 0 else float("inf")
    out["mesh_out"] = got_scores.tolist()
    manifest = (root / "out" / "manifest.jsonl").read_text().splitlines()
    events = (root / "out" / "events.jsonl").read_text().splitlines()
    out["only_rank0_wrote"] = (len(manifest) == 1
                               and sum('"phase_start"' in e for e in events) == 1)

    # packed cross-assay scoring through the sharded model
    seq_b = "MKTAYIAKQRQISFVKSHFSRQLEE"
    muts_b = [f"{seq_b[p]}{p + 1}{'A' if seq_b[p] != 'A' else 'C'}" for p in (0, 3, 7, 11, 19)]
    assays = [(target, mutants), (seq_b, muts_b)]
    kwargs = dict(chunk=data_axis * 2 + 1, super_chunks=2, pad_to_multiple=8, window=48)
    base = score_assays_packed(tiny, assays, **kwargs)
    packed_tp = score_assays_packed(esm2.make_sharded_apply_fn(tiny, mesh), assays, **kwargs)
    out["packed"] = max(_max_diff(a, b) for a, b in zip(packed_tp, base))
    out["assays_in"] = [[seq, list(muts)] for seq, muts in assays]
    out["packed_out"] = [np.asarray(a).tolist() for a in packed_tp]
    out["packed_kwargs"] = kwargs

    # a mesh the world cannot hold, and an axis that does not exist, raise
    try:
        make_mesh(data=world + 1, model=1, device="cpu")
        out["too_small_raises"] = False
    except ValueError:
        out["too_small_raises"] = True
    try:
        mesh_from_spec("data=1,expert=2", device="cpu")
        out["unknown_axis_raises"] = False
    except ValueError:
        out["unknown_axis_raises"] = True
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        n_procs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
        readings = dryrun_multichip(n_procs)
        print(json.dumps({k: v for k, v in readings.items()
                          if not k.endswith(("_in", "_out"))}))
