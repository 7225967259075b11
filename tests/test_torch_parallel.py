"""The port's parallel layer (proteingym_tpu_torch.parallel, ops.ring_attention,
esm2.ShardedEsm, progen3.expert_sharded_apply) on the CPU.

One 4-process gloo dry run (``dryrun_multichip(4)``, started once for the
module) holds the TP x DP training step, the expert-parallel MoE forward,
ring attention, ``score --mesh data=2,model=2`` through the CLI (chunks of
5 rows over a data axis of 2) and packed x TP against single-process
runs, each within its ``dryrun.TOLERANCES`` entry (float32 sums in other
orders). Its outputs are also held against the JAX package on the 8
virtual devices of tests/conftest.py, on the same weights (the dry run's
seeded models, with nonzero biases in ESM's, crossing as one state dict)
and inputs, all float32
inside ``jax.enable_x64(False)``: the ring against ``ring_attention`` over
an 8-device axis (1e-5), the MoE logits against ``expert_sharded_apply``
over a 4-device "expert" axis (1e-5), the ``--mesh`` scores against
``score_esm`` with ``--mesh data=2,model=2`` (1e-5), the packed x TP
scores against ``score_assays_packed`` through the JAX sharded apply on
the same mesh (1e-5), and the TP x DP step's loss against ``mlm_loss`` on
the step's masks (1e-5). The port's ESM plan is held against the JAX
``esm_param_sharding`` leaf by leaf.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import esm_train as jtrain
from proteingym_tpu.models import progen3 as jp3
from proteingym_tpu.models.packed_scoring import score_assays_packed as jax_packed
from proteingym_tpu.ops.flash_attention import force_xla_attention
from proteingym_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from proteingym_tpu.parallel import mesh as jmesh
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import progen3 as tp3
from proteingym_tpu_torch.parallel import dryrun
from proteingym_tpu_torch.parallel import mesh as tmesh

WORLD = 4
# XLA's lowest optimisation level: seconds fewer to compile, the same
# float32 operations
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def dry():
    return dryrun.dryrun_multichip(WORLD, timeout=240)


@pytest.mark.parametrize("reading", sorted(dryrun.TOLERANCES))
def test_dryrun_reading_within_tolerance(dry, reading):
    assert dry[reading] <= dryrun.TOLERANCES[reading]


def test_dryrun_mesh_and_writes(dry):
    assert dry["mesh"] == "data=2,model=2" and dry["default_mesh"] == "data=4,model=1"
    assert dry["only_rank0_wrote"] and np.isfinite(dry["train_loss_value"])
    assert dry["too_small_raises"] and dry["unknown_axis_raises"]


def test_ring_matches_jax_ring_on_eight_devices(dry):
    rs = np.random.RandomState(1)  # the dry run's ring inputs
    b, h, t, d = 1, 2, 8 * WORLD, 8
    q, k, v = (rs.randn(b, h, t, d) for _ in range(3))
    key_mask = np.ones((b, t), bool)
    key_mask[:, -3:] = False
    with jax.enable_x64(False):
        sp = JMesh(np.asarray(jax.devices()[:8]), ("sp",))
        want = np.asarray(jax_ring_attention(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
                                             sp, axis="sp", key_mask=jnp.asarray(key_mask)))
    np.testing.assert_allclose(np.asarray(dry["ring_out"]), want, atol=1e-5, rtol=0)


def _numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_moe_matches_jax_expert_sharded_apply(dry):
    port_cfg = dryrun.moe_config(WORLD)
    sd = _numpy_state(tp3.init_random(port_cfg, seed=dryrun.MOE_SEED, device="cpu"))
    jc = jp3.ProGen3Config(**{f: getattr(port_cfg, f) for f in jp3.ProGen3Config.__dataclass_fields__
                              if f != "dtype"}, dtype=jnp.float32)
    with jax.enable_x64(False):
        experts = JMesh(np.asarray(jax.devices()[:WORLD]), ("expert",))
        params, toks = jp3.convert_torch_state_dict(sd, jc), jnp.asarray(dry["moe_in"])
        apply = jax.jit(lambda p, t: jp3.expert_sharded_apply(p, jc, experts, t))
        want = np.asarray(apply.lower(params, toks).compile(FAST_COMPILE)(params, toks))
    np.testing.assert_allclose(np.asarray(dry["moe_out"]), want, atol=1e-5, rtol=0)


def test_mesh_scores_match_jax_score_esm_on_a_mesh(dry, tmp_path):
    import types

    import pandas as pd

    # the weights of the dry run's --checkpoint, in a fair-esm file
    torch.save(dryrun.esm_state(), tmp_path / "esm2_tiny.pt")
    target, mutants = dry["assays_in"][0]
    ctx = jscorers.ScoreContext(record=types.SimpleNamespace(target_seq=target),
                                dms_frame=pd.DataFrame({"mutant": mutants}),
                                checkpoint=f"esm2_tiny:{tmp_path / 'esm2_tiny.pt'}", batch_size=5,
                                extra={"mesh": dry["mesh"]})
    with jax.enable_x64(False):
        want = jscorers.score_esm(ctx)["esm2_tiny_score"].to_numpy()
    np.testing.assert_allclose(np.asarray(dry["mesh_out"]), want, atol=1e-5, rtol=0)


def test_packed_tp_matches_jax_packed_on_a_mesh(dry):
    jc = jesm.PRESETS["esm2_tiny"]
    with jax.enable_x64(False):
        mesh = jmesh.mesh_from_spec(dry["mesh"])
        params = jesm.convert_torch_state_dict(dryrun.esm_state(), jc)
        params = jmesh.shard_params(params, jmesh.esm_param_sharding(params, mesh))
        want = jax_packed(jesm.make_sharded_apply_fn(jc, mesh), params,
                          [tuple(a) for a in dry["assays_in"]], **dry["packed_kwargs"])
    assert len(want) == len(dry["packed_out"]) == 2
    for got, w in zip(dry["packed_out"], want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(w), atol=1e-5, rtol=0)


def test_tp_dp_step_loss_matches_jax_mlm_loss(dry):
    jc = jesm.PRESETS["esm2_tiny"]
    b = {k: np.asarray(v) for k, v in dry["train_in"].items()}
    with jax.enable_x64(False), force_xla_attention():
        args = (jesm.convert_torch_state_dict(dryrun.esm_state(), jc),
                jnp.asarray(b["masked"], jnp.int32),
                jnp.asarray(b["tokens"], jnp.int32), jnp.asarray(b["target_mask"]),
                jnp.asarray(b["weights"], jnp.float32))
        loss = jax.jit(lambda p, *batch: jtrain.mlm_loss(p, jc, *batch))
        want = float(loss.lower(*args).compile(FAST_COMPILE)(*args))
    assert abs(dry["train_loss_value"] - want) <= 1e-5, (dry["train_loss_value"], want)


@pytest.mark.parametrize("spec,error", [("data=2,expert=2", "Unknown mesh axis 'expert'"),
                                        ("pipe=2", "Unknown mesh axis 'pipe'")])
def test_mesh_from_spec_unknown_axis(spec, error):
    with pytest.raises(ValueError, match=error):
        tmesh.mesh_from_spec(spec, device="cpu")
    with pytest.raises(ValueError, match=error):
        jmesh.mesh_from_spec(spec)


def _jax_plan_in_torch_names(params, shardings):
    """{fair-esm name: split dim of the torch tensor} from the JAX plan: a
    dense kernel is (in, out) in JAX and (out, in) in torch."""
    plan = {}

    def dim(sharding, transpose):
        spec = list(sharding.spec)
        if "model" not in spec:
            return None
        return 1 - spec.index("model") if transpose else spec.index("model")

    def dense(name, s):
        plan[f"{name}.weight"] = dim(s["kernel"], True)
        plan[f"{name}.bias"] = dim(s["bias"], False)

    def ln(name, s):
        plan[f"{name}.weight"], plan[f"{name}.bias"] = dim(s["scale"], False), dim(s["bias"], False)

    plan["embed_tokens.weight"] = dim(shardings["embed_tokens"], False)
    for i, layer in enumerate(shardings["layers"]):
        ln(f"layers.{i}.self_attn_layer_norm", layer["attn_ln"])
        for proj in ("q", "k", "v", "out"):
            dense(f"layers.{i}.self_attn.{proj}_proj", layer[proj])
        ln(f"layers.{i}.final_layer_norm", layer["ffn_ln"])
        dense(f"layers.{i}.fc1", layer["fc1"])
        dense(f"layers.{i}.fc2", layer["fc2"])
    ln("emb_layer_norm_after", shardings["final_ln"])
    dense("lm_head.dense", shardings["lm_head"]["dense"])
    ln("lm_head.layer_norm", shardings["lm_head"]["ln"])
    plan["lm_head.bias"] = dim(shardings["lm_head"]["bias"], False)
    if "embed_positions" in shardings:
        plan["embed_positions.weight"] = dim(shardings["embed_positions"], False)
    if "emb_ln_before" in shardings:
        ln("emb_layer_norm_before", shardings["emb_ln_before"])
    return plan


@pytest.mark.parametrize("name,model_axis", [("esm2", 2), ("esm2", 4), ("esm1b", 2),
                                             ("odd_width", 4)])
def test_esm_plan_matches_jax_leaf_by_leaf(name, model_axis):
    kw = dict(esm2=dict(), esm1b=dict(use_rotary=False, emb_layer_norm_before=True),
              odd_width=dict())[name]
    width = 66 if name == "odd_width" else 64  # 66 % 4: the split dims replicate
    heads = 6 if name == "odd_width" else 4
    jc = jesm.EsmConfig(name, 2, width, heads, dtype=jnp.float32, **kw)
    tc = tesm.EsmConfig(name, 2, width, heads, dtype=torch.float32, **kw)
    with jax.enable_x64(False):
        params = jesm.init_params(jax.random.PRNGKey(0), jc)
        want = _jax_plan_in_torch_names(
            params, jmesh.esm_param_sharding(params, jmesh.make_mesh(8 // model_axis,
                                                                     model_axis)))
    model = tesm.EsmModel(tc, device="meta")
    got = tmesh.esm_param_sharding(model, tmesh.Mesh(data=8 // model_axis, model=model_axis))
    assert got == want


def test_generic_plan_matches_jax():
    shapes = {"a": (512, 256), "b": (300, 2048), "c": (7, 5), "d": (1024,), "e": (258, 258)}
    with jax.enable_x64(False):
        want = jmesh.generic_tp_sharding({k: np.zeros(s, np.float32) for k, s in shapes.items()},
                                         jmesh.make_mesh(4, 2))
    got = tmesh.generic_tp_sharding({k: torch.zeros(s) for k, s in shapes.items()},
                                    tmesh.Mesh(data=4, model=2))
    for k in shapes:
        spec = list(want[k].spec)
        assert got[k] == (spec.index("model") if "model" in spec else None), k


def test_shard_params_takes_this_ranks_chunk():
    t = torch.arange(24.0).view(4, 6)
    plan = {"w": 1, "b": None}
    part = tmesh.shard_params({"w": t, "b": t}, plan, tmesh.Mesh(data=1, model=3, rank=2))
    assert torch.equal(part["w"], t[:, 4:6]) and part["b"] is t
    assert part["w"].is_contiguous() and part["w"].data_ptr() != t.data_ptr()


def test_packed_refuses_a_mesh(tmp_path):
    # the packed batch fails as a whole, as the JAX scorer refuses a mesh,
    # before any process group is joined
    import json

    from proteingym_tpu_torch.pipeline import cli

    seq = "MKTAYIAKQRQISFVKSHF"
    (tmp_path / "dms").mkdir()
    (tmp_path / "ref.csv").write_text(f"DMS_id,DMS_filename,target_seq\nP,P.csv,{seq}\n")
    (tmp_path / "dms" / "P.csv").write_text("mutant\nK2A\n")
    rc = cli.main(["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--device", "cpu",
                   "--packed", "--mesh", "data=1,model=1", "--quiet",
                   "--dms-reference", str(tmp_path / "ref.csv"),
                   "--dms-dir", str(tmp_path / "dms"), "--output-dir", str(tmp_path / "out")])
    assert rc == 1 and not (tmp_path / "out" / "P.csv").exists()
    events = [json.loads(x) for x in (tmp_path / "out" / "events.jsonl").read_text().splitlines()]
    assert any(e["event"] == "task_failed" and "mesh" in e["error"] for e in events)
    assert not torch.distributed.is_initialized()


def test_extra_cannot_carry_the_mesh(tmp_path):
    # the mesh is --mesh's alone: a mesh in --extra would shard the model
    # with every rank writing
    from proteingym_tpu_torch.pipeline import cli

    seq = "MKTAYIAKQRQISFVKSHF"
    (tmp_path / "dms").mkdir()
    (tmp_path / "ref.csv").write_text(f"DMS_id,DMS_filename,target_seq\nP,P.csv,{seq}\n")
    (tmp_path / "dms" / "P.csv").write_text("mutant\nK2A\n")
    rc = cli.main(["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--device", "cpu",
                   "--extra", "mesh=data=1,model=1", "--quiet",
                   "--dms-reference", str(tmp_path / "ref.csv"),
                   "--dms-dir", str(tmp_path / "dms"), "--output-dir", str(tmp_path / "out")])
    assert rc == 2 and not (tmp_path / "out").exists()
    assert not torch.distributed.is_initialized()


def test_packed_mesh_on_a_later_rank_writes_nothing(tmp_path, monkeypatch):
    # under torchrun every rank runs the command; a rank other than 0 fails
    # the packed batch without touching the manifest or the event log
    from proteingym_tpu_torch.pipeline import cli

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.launch_rank() == 1
    seq = "MKTAYIAKQRQISFVKSHF"
    (tmp_path / "dms").mkdir()
    (tmp_path / "ref.csv").write_text(f"DMS_id,DMS_filename,target_seq\nP,P.csv,{seq}\n")
    (tmp_path / "dms" / "P.csv").write_text("mutant\nK2A\n")
    rc = cli.main(["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--device", "cpu",
                   "--packed", "--mesh", "data=2,model=1", "--quiet",
                   "--dms-reference", str(tmp_path / "ref.csv"),
                   "--dms-dir", str(tmp_path / "dms"), "--output-dir", str(tmp_path / "out")])
    assert rc == 1
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == []
    assert not torch.distributed.is_initialized()
