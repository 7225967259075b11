"""The port's EVE (proteingym_tpu_torch.models.eve, inference) against the
JAX package's, in float32 at small widths: the encoder, the Bayesian
decoder with the noise drawn by JAX's own key split (in the order of the
JAX ``decode``), the loss pieces, the one-hots, the evol indices and the
EVE prior on a checkpoint whose every log variance is -60 (each draw then
equals its mean, so the two generators' draws do not matter), the
reference-layout checkpoint file read on both sides, and the ``eve`` /
``deepsequence`` scorers from checkpoints through both CLIs (training is
held by test_torch_eve_train.py and test_torch_cli.py).
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import eve as jeve
from proteingym_tpu.models import retrieval as jret
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.models import eve as teve
from proteingym_tpu_torch.models import retrieval as tret
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import cli as tcli

# float32 on both sides, sums in other orders: log-probs of magnitude ~3-30
ATOL = 1e-4
# ELBOs sum 20 x L BCE terms of magnitude ~1-30; evol indices are their
# differences
ELBO_ATOL = 2e-3
AA = "ACDEFGHIKLMNPQRSTVWY"
SMALL = dict(seq_len=9, encoder_hidden=(24, 16), decoder_hidden=(16, 24), z_dim=4,
             convolution_depth=6)


def _jax_params(config, seed=0, logvar=None):
    """JAX ``init_params`` with every bias and mean perturbed; every decoder
    log variance (and the latent's bias, its weights zeroed) set to
    ``logvar`` when given."""
    params = jax.tree.map(np.asarray, jeve.init_params(jax.random.PRNGKey(seed), config))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + (rs.randn(*x.shape).astype(np.float32) * 0.3
                             if "logvar" not in jax.tree_util.keystr(path) else 0), params)
    if logvar is not None:
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: (np.full_like(x, logvar)
                             if "logvar" in jax.tree_util.keystr(path).split("'")[-2] else x),
            params)
        params["encoder"]["logvar"]["w"] = np.zeros_like(params["encoder"]["logvar"]["w"])
        params["encoder"]["logvar"]["b"] = np.full_like(params["encoder"]["logvar"]["b"], logvar)
    return params


def _both(seed=0, logvar=None, **overrides):
    jcfg = jeve.EveConfig(**{**SMALL, **overrides})
    tcfg = teve.EveConfig(**{**SMALL, **overrides})
    params = _jax_params(jcfg, seed, logvar)
    model = teve.load_state_dict(teve.params_from_jax(params, tcfg), tcfg, device="cpu")
    return model, jax.tree.map(jnp.asarray, params), jcfg


def _onehots(rs, n, length):
    x = np.zeros((n, length, 20), np.float32)
    x[np.arange(n)[:, None], np.arange(length)[None], rs.randint(0, 20, (n, length))] = 1
    return x


def test_encode_equals_jax():
    model, params, jcfg = _both(1)
    x = _onehots(np.random.RandomState(1), 5, 9)
    with torch.no_grad():
        mu, logvar = model.encode(torch.from_numpy(x))
    jmu, jlogvar = jeve.encode(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(mu.numpy(), jmu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logvar.numpy(), jlogvar, atol=ATOL, rtol=0)


@pytest.mark.parametrize("options", [
    {},                                                   # convolution + temperature
    {"convolve_output": False, "include_sparsity": True, "num_tiles_sparsity": 4},
    {"include_temperature_scaler": False},
], ids=["conv_temp", "sparsity_temp", "conv"])
def test_decode_with_jax_noise_equals_jax(options):
    model, params, jcfg = _both(2, logvar=-1.0, **options)
    z = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    # the JAX decode's draws: one key each, in its order
    keys = jax.random.split(key, 4 + 2 * len(jcfg.decoder_hidden))
    noise = [torch.from_numpy(np.array(jax.random.normal(k, mean.shape), np.float32))[None]
             for k, (mean, _) in zip(keys, model.variational())]
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z)[None], noise=noise)[0].numpy()
    want = np.asarray(jeve.decode(params, jcfg, jnp.asarray(z), key))
    assert got.shape == (3, 9, 20)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the noise matters: the means alone give other log-probs
    with torch.no_grad():
        means = model.decode(torch.from_numpy(z)[None], noise=[0 * n for n in noise])[0]
    assert float((means - torch.from_numpy(got)).abs().max()) > 1e-2


def test_loss_pieces_equal_jax():
    rs = np.random.RandomState(4)
    logits, targets = rs.randn(6, 30).astype(np.float32) * 5, (rs.rand(6, 30) > 0.5) * 1.0
    np.testing.assert_allclose(
        teve._bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        jeve._bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)), atol=1e-6, rtol=0)
    mu, logvar = rs.randn(5, 4).astype(np.float32), rs.randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(
        teve.kld_latent(torch.from_numpy(mu), torch.from_numpy(logvar)).numpy(),
        jeve.kld_latent(jnp.asarray(mu), jnp.asarray(logvar)), atol=1e-5, rtol=0)


def test_onehot_mutants_equal_jax():
    codes = np.array([0, 5, -1, 19, 3, 7])
    mutants = ["A1C", "", "F2W:Y4A", "D5E"]
    np.testing.assert_array_equal(teve.onehot_mutants(codes, mutants, AA),
                                  jeve.onehot_mutants(codes, mutants, AA))
    np.testing.assert_array_equal(teve.onehot_sequence("acXd"),
                                  teve.onehot_mutants(np.array([0, 1, -1, 2]), [""], AA)[0])


def test_evol_indices_on_a_deterministic_checkpoint_equal_jax():
    model, params, jcfg = _both(5, logvar=-60.0)
    rs = np.random.RandomState(5)
    wt, muts = _onehots(rs, 1, 9)[0], _onehots(rs, 7, 9)
    got = teve.evol_indices(model, wt, muts, num_samples=10, seed=3)
    want = jeve.evol_indices(params, jcfg, wt, muts, num_samples=10, seed=3)
    assert got.dtype == np.float32 and got.shape == (7,)
    np.testing.assert_allclose(got, want, atol=ELBO_ATOL, rtol=0)
    assert np.ptp(got) > 1.0  # the mutants differ


def test_mean_elbos_average_their_draws():
    # each of the 8 draws (2 steps of 4) differs; the mean equals the mean
    # of the per-draw ELBOs computed one draw at a time with the same noise
    model, _, _ = _both(6, logvar=-1.0)
    x = torch.from_numpy(_onehots(np.random.RandomState(6), 3, 9))
    got = teve.mean_elbos(model, x.numpy(), num_samples=7, chunk=4, seed=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        mu, logvar = model.encode(x)
        bce = []
        for _ in range(2):
            z = mu + torch.exp(0.5 * logvar) * torch.randn((4, *mu.shape), generator=gen)
            noise = model.draw_noise(4, gen)
            for s in range(4):
                recon = model.decode(z[s:s + 1], noise=[n[s:s + 1] for n in noise])[0]
                bce.append(teve._bce_with_logits(recon.reshape(3, -1), x.reshape(3, -1)).sum(1))
    want = -(torch.stack(bce).mean(0) + teve.kld_latent(mu, logvar))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-3, rtol=0)


def test_eve_log_prior_on_a_deterministic_checkpoint_equals_jax():
    model, params, jcfg = _both(7, logvar=-60.0)
    focus_seq, focus_cols = "ACDEFGHIK", np.array([0, 1, 2, 4, 5, 6, 8, 9, 10])
    # 150 draws in chunks of 64: 128 draws on both sides
    got = tret.eve_log_prior([model, model], focus_seq, focus_cols, msa_start=3, full_len=16,
                             num_samples=150, sample_chunk=64)
    want = jret.eve_log_prior([params, params], jcfg, focus_seq, focus_cols, msa_start=3,
                              full_len=16, num_samples=150, sample_chunk=64)
    assert got.shape == (16, 25) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    assert live.sum() == 9 * 20
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


def test_reference_checkpoint_file_loads_on_both_sides(tmp_path):
    config = teve.EveConfig(**SMALL)
    model = teve.init_random(config, seed=8, device="cpu")
    torch.save(teve.checkpoint_dict(model), tmp_path / "eve.pt")
    loaded, cfg = tckpt.load_eve_checkpoint(tmp_path / "eve.pt", device="cpu")
    jparams, jcfg = jeve.load_torch_checkpoint(tmp_path / "eve.pt")
    assert cfg == config
    assert {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)} == \
        dataclasses.asdict(cfg)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 model.state_dict().values()))
    x = _onehots(np.random.RandomState(8), 4, 9)
    with torch.no_grad():
        mu, _ = loaded.encode(torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), jeve.encode(jparams, jcfg, jnp.asarray(x))[0],
                               atol=ATOL, rtol=0)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_eve_checkpoint(tmp_path / "orbax", device="cpu")


def test_init_random_follows_the_jax_distribution():
    config = teve.EveConfig(**SMALL)
    sd = teve.init_random(config, seed=1, device="cpu").state_dict()
    jsd = teve.params_from_jax(jax.tree.map(np.asarray, jeve.init_params(
        jax.random.PRNGKey(0), jeve.EveConfig(**SMALL))), config)
    assert set(sd) == set(jsd)
    for key in sd:
        assert sd[key].shape == jsd[key].shape, key
        if key.startswith("decoder") and "log_var" in key or key.endswith("bias") or (
                "temperature" in key):
            assert torch.equal(sd[key], jsd[key]), key  # constants
    assert torch.equal(sd["encoder.fc_log_var.bias"], torch.full((4,), -10.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teve.init_random(config, seed=1)  # the default is the card


# ---------------------------------------------------------------------------
# The eve / deepsequence scorers through both CLIs
# ---------------------------------------------------------------------------

def _eve_world(tmp_path, n_files=1):
    """A 14-residue target whose 9-column alignment covers residues 3-11,
    deterministic EVE files over its focus columns, and mutants: in focus,
    a double, off the focus, a wrong wild-type letter, to a letter outside
    the alphabet, and WT."""
    rs = np.random.RandomState(9)
    target = "".join(AA[i] for i in rs.randint(0, 20, 14))
    focus = target[2:11]
    seqs = [focus] + ["".join(AA[i] if rs.rand() > 0.3 else c for i, c in
                              zip(rs.randint(0, 20, 9), focus)) for _ in range(30)]
    (tmp_path / "msa").mkdir()
    with open(tmp_path / "msa" / "FAM.a2m", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">FAM/3-11\n{s}\n" if i == 0 else f">h{i}/1-9\n{s}\n")
    paths = []
    for k in range(n_files):
        model, _, _ = _both(10 + k, logvar=-60.0)
        torch.save(teve.checkpoint_dict(model), tmp_path / f"eve{k}.pt")
        paths.append(str(tmp_path / f"eve{k}.pt"))
    sub = lambda p, a: f"{target[p - 1]}{p}{a if target[p - 1] != a else 'G'}"
    wrong = next(a for a in AA if a != target[4])
    mutants = [sub(3, "W"), sub(7, "A"), f"{sub(4, 'P')}:{sub(11, 'K')}", sub(12, "A"),
               f"{wrong}5A", f"{target[5]}6X", "WT"]
    with open(tmp_path / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_T", "FAM_T.csv", "P1", target, 14, "FAM.a2m", 3, 11, 0.2, "FAM.npy"])
    (tmp_path / "dms").mkdir()
    with open(tmp_path / "dms" / "FAM_T.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "mutated_sequence"])
        w.writerows([m, target] for m in mutants)
    return paths


def _run_both(tmp_path, model, checkpoint):
    common = ["--checkpoint", checkpoint, "--msa-dir", str(tmp_path / "msa"),
              "--weights-dir", str(tmp_path / "w"), "--dms-reference", str(tmp_path / "ref.csv"),
              "--dms-dir", str(tmp_path / "dms"), "--quiet", "--extra", "num_samples=6"]
    assert tcli.main(["score", "--model", model, "--device", "cpu", "--output-dir",
                      str(tmp_path / "port")] + common) == 0
    assert jcli.main(["--platform", "cpu", "score", "--model", model, "--output-dir",
                      str(tmp_path / "jax")] + common) == 0
    out = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "FAM_T.csv", newline="") as f:
            rows = list(csv.reader(f))
        out[side] = rows
    return out["port"], out["jax"]


@pytest.mark.parametrize("model,n_files,column", [
    ("eve", 1, "evol_indices"), ("eve", 2, "evol_indices_ensemble"),
    ("deepsequence", 1, "DeepSequence_evol_indices")])
def test_eve_cli_writes_the_jax_cli_file(tmp_path, model, n_files, column):
    paths = _eve_world(tmp_path, n_files)
    port, jax_rows = _run_both(tmp_path, model, ",".join(paths))
    assert port[0] == jax_rows[0] == ["mutant", "mutated_sequence", column]
    got = np.asarray([float(r[2]) if r[2] else np.nan for r in port[1:]])
    want = np.asarray([float(r[2]) if r[2] else np.nan for r in jax_rows[1:]])
    # off the focus, a wrong letter, a letter outside the alphabet: empty
    np.testing.assert_array_equal(np.isnan(got), [0, 0, 0, 1, 1, 1, 0])
    np.testing.assert_allclose(got, want, atol=ELBO_ATOL, rtol=0)
    assert got[-1] == 0.0 and len(set(got[:3])) == 3


def test_focus_model_scores_literal_wt_rows_zero():
    # a literal WT row is 0 whatever the score function gives the empty
    # mutant (EVE's would be a Monte Carlo difference of two WT ELBOs)
    from types import SimpleNamespace

    from proteingym_tpu_torch.pipeline.scorers import _score_focus_model

    ctx = SimpleNamespace(record=SimpleNamespace(MSA_start=3))
    msa = SimpleNamespace(focus_cols=np.arange(4), focus_seq_trimmed="acDE")
    got = _score_focus_model(ctx, msa, lambda wt, remapped: [7.0] * len(remapped),
                             ["A3C", "WT", "D5E", "", "A1C"])
    np.testing.assert_array_equal(got, [7.0, 0.0, 7.0, 0.0, np.nan])

