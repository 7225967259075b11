"""Scorer registry (counterpart of proteingym_tpu/pipeline/scorers.py):
``esm`` (masked marginals), ``poet`` (MSA-conditioned likelihood),
``msa_transformer`` (MSA masked marginals in focus-column coordinates),
``tranception`` / ``trancepteve`` (autoregressive, with MSA and EVE
retrieval, and whole indel sequences with ``indel_mode``), ``eve`` /
``deepsequence`` (evol indices of VAEs trained from the MSA or read from
checkpoints), the alignment baselines ``site_independent``, ``potts`` /
``evmutation``, ``hmm``, ``wavenet`` (a causal CNN trained on the MSA's
rows; whole sequences, so indels too), ``gemme`` / ``escott``,
``siterm``, ``rsalor`` and ``provean`` (whole sequences too), the
autoregressive zoo ``progen2``, ``rita``, ``protgpt2``, ``progen3`` and
``unirep`` (whole sequences, so indels too), the masked LMs ``esmc``,
``esm3`` (structure-conditioned with --structure-dir), ``xtrimopglm``
(MLM or AR) and ``carp``, plus
``score_esm_packed_batch``, the cross-assay packed ESM path.

A scorer is ``scorer(ctx: ScoreContext)`` and returns either ``{column:
scores}``, which the CLI writes after the input columns, or a whole
``Table``, which it writes as it is (Tranception's, as the JAX CLI writes
its frame).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch.data.mutants import is_wt_row, parse_mutant
from proteingym_tpu_torch.data.reference import AssayRecord
from proteingym_tpu_torch.devices import no_tf32

SCORERS: Dict[str, Callable] = {}


def register_scorer(name: str):
    def deco(fn):
        SCORERS[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class ScoreContext:
    """Everything a scorer needs for one (model, assay) task."""

    record: AssayRecord
    mutants: List[str]
    device: torch.device
    mutated_sequences: List[str] = dataclasses.field(default_factory=list)
    msa_dir: Optional[Path] = None
    weights_dir: Optional[Path] = None
    checkpoint: Optional[str] = None  # checkpoint path or preset name
    structure_dir: Optional[Path] = None  # <UniProt_ID>.pdb or <DMS_id>.pdb
    indel_mode: bool = False
    batch_size: int = 32
    extra: dict = dataclasses.field(default_factory=dict)
    _msa: object = dataclasses.field(default=None, init=False, repr=False)

    def load_msa(self, theta: Optional[float] = None):
        """Load and preprocess the assay's MSA, with sequence weights read
        from ``weights_dir/<weight_file_name>`` when its length matches the
        alignment, and otherwise computed on ``device`` and saved there as
        float64 ``.npy`` (the JAX package reads and writes the same file)."""
        if self._msa is not None:
            return self._msa
        from proteingym_tpu_torch.msa.parser import load_msa
        from proteingym_tpu_torch.msa.weights import sequence_weights

        if self.msa_dir is None or self.record.MSA_filename is None:
            raise FileNotFoundError(f"No MSA available for {self.record.DMS_id}")
        msa = load_msa(Path(self.msa_dir) / self.record.MSA_filename)
        theta = theta if theta is not None else (self.record.MSA_theta or 0.2)

        weights = None
        wpath = None
        if self.weights_dir is not None and self.record.weight_file_name:
            wpath = Path(self.weights_dir) / self.record.weight_file_name
            if wpath.exists():
                weights = np.load(wpath)
        if weights is None or len(weights) != msa.num_sequences:
            weights = sequence_weights(msa.matrix, theta=theta, device=self.device)
            if wpath is not None:
                wpath.parent.mkdir(parents=True, exist_ok=True)
                np.save(wpath, weights)
        self._msa = dataclasses.replace(msa, weights=weights)
        return self._msa

    @property
    def msa_start0(self) -> int:
        """The alignment's 0-indexed start in full-sequence coordinates."""
        return (self.record.MSA_start or 1) - 1

    def structure_path(self) -> Optional[Path]:
        """``structure_dir/<UniProt_ID>.pdb``, else ``<DMS_id>.pdb``, if
        either exists."""
        if self.structure_dir is not None:
            for stem in (self.record.UniProt_ID, self.record.DMS_id):
                pdb = Path(self.structure_dir) / f"{stem}.pdb"
                if pdb.exists():
                    return pdb
        return None


def _load_structure(ctx: ScoreContext) -> np.ndarray:
    """The assay's (L, 4, 3) backbone from --structure-dir; raises
    FileNotFoundError without one."""
    from proteingym_tpu_torch.data.structures import parse_pdb_backbone

    if ctx.structure_dir is None:
        raise FileNotFoundError(f"{ctx.record.DMS_id}: needs --structure-dir")
    pdb = ctx.structure_path()
    if pdb is None:
        raise FileNotFoundError(f"No PDB for {ctx.record.DMS_id}")
    return parse_pdb_backbone(pdb)[0]


# ---------------------------------------------------------------------------
# Alignment-based scorers (from the MSA alone)
# ---------------------------------------------------------------------------

POTTS_ALPHABET = "-ACDEFGHIKLMNPQRSTVWY"


def _index_list(msa, ctx: ScoreContext) -> np.ndarray:
    """The target-sequence position of each focus column."""
    start = msa.focus_start if msa.focus_start is not None else (ctx.record.MSA_start or 1)
    return np.asarray(msa.focus_cols) + start


@register_scorer("site_independent")
def score_site_independent(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """The weighted single-site frequency model, trained from the MSA (ref
    EVmutation/score_mutants.py:14, to_independent_model)."""
    from proteingym_tpu_torch.models.potts import train_site_independent

    msa = ctx.load_msa()
    model = train_site_independent(msa.matrix, msa.weights, POTTS_ALPHABET,
                                   _index_list(msa, ctx), msa.focus_seq_trimmed)
    return {"Site_Independent_score": model.delta_hamiltonians(ctx.mutants, device=ctx.device)}


@register_scorer("potts")
@register_scorer("evmutation")
def score_potts(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """The Potts model of a plmc ``.model`` file given as --checkpoint, or
    else trained from the MSA by pseudolikelihood (``--extra
    plm_steps=``, 300 Adam steps)."""
    from proteingym_tpu_torch.models.potts import read_plmc_model, train_potts_plm

    if ctx.checkpoint:
        model = read_plmc_model(ctx.checkpoint)
    else:
        msa = ctx.load_msa()
        model = train_potts_plm(msa.matrix, msa.weights, POTTS_ALPHABET, _index_list(msa, ctx),
                                msa.focus_seq_trimmed,
                                steps=int(ctx.extra.get("plm_steps", 300)), device=ctx.device)
    return {"EVmutation_score": model.delta_hamiltonians(ctx.mutants, device=ctx.device)}


@register_scorer("hmm")
def score_hmm(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """Profile-HMM forward log-odds against the WT (ref HMM/score_hmm.py:
    9-111): substitution assays score the slice the MSA covers,
    ``--indel-mode`` whole sequences."""
    from proteingym_tpu_torch.models.hmm import build_profile_hmm, score_sequences

    msa = ctx.load_msa()
    model = build_profile_hmm(msa.matrix, msa.weights)
    seqs, wt = list(ctx.mutated_sequences), ctx.record.target_seq
    if not ctx.indel_mode:
        s0, s1 = ctx.msa_start0, ctx.record.MSA_end or len(wt)
        seqs, wt = [s[s0:s1] for s in seqs], wt[s0:s1]
    lls = score_sequences(model, seqs + [wt], device=ctx.device)
    return {"HMM_score": lls[:-1] - lls[-1]}


@register_scorer("wavenet")
def score_wavenet(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """WaveNet / SeqDesign (models/wavenet.py): the causal CNN from
    ``init_random(seed=0)``, trained on the MSA's rows by weight (``--extra
    steps=`` 400, ``num_layers=`` 12, ``seed=`` 0), then each
    ``mutated_sequence`` scored whole by its log-likelihood, so indel
    assays too. The column is ``Wavenet_score``, as the JAX scorer names
    it."""
    from proteingym_tpu_torch.models import wavenet

    msa = ctx.load_msa()
    config = wavenet.WavenetConfig(steps=int(ctx.extra.get("steps", 400)),
                                   num_layers=int(ctx.extra.get("num_layers", 12)))
    model = wavenet.init_random(config, seed=0, device=ctx.device)
    model, _ = wavenet.train(model, config, msa.sequences(), weights=msa.weights,
                             seed=int(ctx.extra.get("seed", 0)))
    scores = wavenet.score_sequences(model, ctx.mutated_sequences, batch=ctx.batch_size)
    return {"Wavenet_score": scores}


def _score_gemme(ctx: ScoreContext, name: str) -> Dict[str, np.ndarray]:
    """GEMME (models/gemme.py) at its defaults, in focus-column
    coordinates; ``--extra mode=combined|epistatic|independent``. As
    ``escott``, the table goes through the reference's landscape
    extraction (WT cells 0), and a structure in --structure-dir scales each
    mutant by its positions' mean burial weight 2 - RSA (ref
    escott/compute_fitness.py); a structure whose length differs from the
    target's is skipped with a message, as the JAX scorer does. A literal
    WT row fails ``escott``, as it does the JAX scorer."""
    from proteingym_tpu_torch.models import gemme

    msa = ctx.load_msa()
    model = gemme.fit_gemme(msa.matrix, msa.weights, device=ctx.device)
    mode = ctx.extra.get("mode", "combined")
    table = {"combined": model.combined(), "epistatic": model.pred_epi,
             "independent": model.pred_ind}[mode]
    if name == "escott":
        def score_fn(wt, remapped):
            aa_cols = [model.alphabet.index(a) for a in gemme.ESCOTT_AA_VOCAB]
            wt_rows = np.asarray([model.alphabet.index(a) for a in wt])
            land = table[:, aa_cols] - table[np.arange(len(wt)), wt_rows][:, None]
            return np.asarray(gemme.escott_extract_scores(land, remapped, offset=1))
    else:
        def score_fn(wt, remapped):
            return gemme.score_mutants(model, wt, remapped, mode=mode)
    scores = _score_focus_model(ctx, msa, score_fn, ctx.mutants)
    pdb = ctx.structure_path() if name == "escott" else None
    if pdb is not None and ctx.mutants:
        from proteingym_tpu_torch.data.structures import parse_pdb_backbone
        from proteingym_tpu_torch.models.rsalor import rsa_from_structure

        coords, _ = parse_pdb_backbone(pdb)
        if coords.shape[0] != len(ctx.record.target_seq):
            # the parser drops incomplete residues and keeps no numbering, so
            # DMS positions cannot index the RSA array: unmodulated scores
            print(f"escott/{ctx.record.DMS_id}: structure length {coords.shape[0]} != "
                  f"target {len(ctx.record.target_seq)}; skipping RSA modulation")
        else:
            weight = 1.0 + (1.0 - rsa_from_structure(coords))
            scores = scores * np.asarray([
                float(weight[np.clip([int(t[1:-1]) - 1 for t in m.split(":")], 0,
                                     len(weight) - 1)].mean()) for m in ctx.mutants])
    return {"ESCOTT_score" if name == "escott" else "GEMME_score": scores}


@register_scorer("gemme")
def score_gemme(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    return _score_gemme(ctx, "gemme")


@register_scorer("escott")
def score_escott(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    return _score_gemme(ctx, "escott")


@register_scorer("siterm")
def score_siterm(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """SiteRM (models/siterm.py): per-site 21-state rate matrices from
    cherry transitions with the prior's pseudocounts (``--extra epochs=``
    100, ``max_pairs=``, ``prior_matrix=`` a cherryml-format file such as
    the reference's lg_with_gaps.txt; the uniform prior without it), or
    with ``--extra method=f81`` the closed-form F81 model."""
    from proteingym_tpu_torch.models import siterm

    msa = ctx.load_msa()
    mp = ctx.extra.get("max_pairs")
    if ctx.extra.get("method") == "f81":
        model = siterm.fit_siterm(msa.matrix, msa.weights, max_pairs=mp, device=ctx.device)
        score_fn = lambda wt, remapped: siterm.score_mutants(model, wt, remapped)
    else:
        prior_Q = None
        if ctx.extra.get("prior_matrix"):
            prior_Q, states = siterm.read_rate_matrix(ctx.extra["prior_matrix"])
            prior_Q = siterm.reorder_rate_matrix(prior_Q, states)
        gtr = siterm.fit_site_rate_matrices(
            msa.matrix, msa.weights, prior_Q=prior_Q, epochs=int(ctx.extra.get("epochs", 100)),
            max_pairs=int(mp) if mp else None, device=ctx.device)
        score_fn = lambda wt, remapped: siterm.score_mutants_gtr(gtr, wt, remapped,
                                                                 device=ctx.device)
    return {"SiteRM_score": _score_focus_model(ctx, msa, score_fn, ctx.mutants)}


@register_scorer("rsalor")
def score_rsalor(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """RSALOR (models/rsalor.py): RSA x MSA log-odds, the RSA from the
    structure in --structure-dir when there is one, else 0.5. The column
    is ``RSALOR_score``, as the JAX scorer names it (the registry merges
    ``RSALOR``)."""
    from proteingym_tpu_torch.models import rsalor

    msa = ctx.load_msa()
    try:
        coords = _load_structure(ctx)
    except FileNotFoundError:
        coords = None
    model = rsalor.fit_rsalor(msa.matrix, msa.weights, coords=coords, device=ctx.device)
    scores = _score_focus_model(
        ctx, msa, lambda wt, remapped: rsalor.score_mutants(model, wt, remapped), ctx.mutants)
    return {"RSALOR_score": scores}


@register_scorer("provean")
def score_provean(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """PROVEAN (models/provean.py): delta BLOSUM62 alignment scores of each
    ``mutated_sequence`` (indels too) against a supporting set clustered
    from the alignment's rows (``--extra max_clusters=`` 30,
    ``max_candidates=`` 200, ``max_per_cluster=`` 5). The column is
    ``Provean_score``, as the JAX scorer names it and the registry's DMS
    indel list merges it (its clinical lists merge ``PROVEAN_score`` and
    ``provean_score``)."""
    from proteingym_tpu_torch.models import provean

    msa = ctx.load_msa()
    wt = ctx.record.target_seq
    clusters = provean.cluster_supporting_set(
        wt, msa.sequences(), max_clusters=int(ctx.extra.get("max_clusters", 30)),
        max_candidates=int(ctx.extra.get("max_candidates", 200)))
    scores = provean.provean_scores(wt, ctx.mutated_sequences, clusters,
                                    max_per_cluster=int(ctx.extra.get("max_per_cluster", 5)),
                                    device=ctx.device)
    return {"Provean_score": scores}


@register_scorer("esm")
def score_esm(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ESM2/ESM-1v masked-marginal scoring.

    ``--extra ensemble=spec1,spec2,...`` scores each checkpoint and averages
    them (the ESM-1v 5-seed ensemble) into ``{name}_ensemble``; otherwise
    the single --checkpoint spec is scored into ``{name}_score``. Each spec
    follows load_esm_checkpoint."""
    from proteingym_tpu_torch.models.esm_scoring import score_assay
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    specs = (
        str(ctx.extra["ensemble"]).split(",")
        if ctx.extra.get("ensemble") else [ctx.checkpoint]
    )
    per_member = []
    name = None
    for spec in specs:
        model, config = load_esm_checkpoint(spec, device=ctx.device)
        name = name or config.name
        per_member.append(score_assay(
            model,
            ctx.record.target_seq,
            ctx.mutants,
            strategy=ctx.extra.get("scoring_strategy", "masked-marginals"),
            chunk=ctx.batch_size,
            window=config.max_positions,
            device=ctx.device,
        ))
        del model  # one member's weights on the device at a time
    column = f"{name}_ensemble" if len(per_member) > 1 else f"{name}_score"
    return {column: np.mean(per_member, axis=0)}


def score_esm_packed_batch(
    tasks: Sequence[Tuple[AssayRecord, Sequence[str]]],
    checkpoint: Optional[str],
    batch_size: int = 32,
    extra: Optional[dict] = None,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Cross-assay packed ESM masked-marginal scoring, the path behind
    ``score --packed``.

    tasks: (AssayRecord, mutant strings) per assay. All assays' masked rows
    share forward batches of ``batch_size`` rows
    (models/packed_scoring.py); the scores equal the per-assay scorer's.
    Returns {DMS_id: {"<checkpoint name>_score": scores}}. ``--extra
    cols_per_forward=k`` opts into k-column masking (~1/k the forwards);
    k=1, the default, is the reference-exact protocol."""
    from proteingym_tpu_torch.models.packed_scoring import score_assays_packed
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    extra = extra or {}
    if extra.get("ensemble") or extra.get("mesh"):
        raise ValueError(
            "--packed does not combine with ensemble/mesh scoring; run "
            "those per-assay"
        )
    if extra.get("scoring_strategy", "masked-marginals") != "masked-marginals":
        raise ValueError("--packed supports masked-marginals only")
    model, config = load_esm_checkpoint(checkpoint, device=device)
    scores = score_assays_packed(
        model, [(rec.target_seq, list(mutants)) for rec, mutants in tasks],
        chunk=batch_size, window=config.max_positions,
        cols_per_forward=int(extra.get("cols_per_forward", 1)),
    )
    return {rec.DMS_id: {f"{config.name}_score": s}
            for (rec, _), s in zip(tasks, scores)}


@register_scorer("poet")
def score_poet(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """PoET family-conditioned autoregressive scoring (ref
    PoET/scripts/score.py): log p(mutant | sampled MSA context), averaged
    over ``--extra n_context_samples=`` weighted context samples of at most
    ``max_context_tokens=`` tokens each."""
    from proteingym_tpu_torch.models.poet import score_assay_poet
    from proteingym_tpu_torch.pipeline.checkpoints import load_poet_checkpoint

    model, _ = load_poet_checkpoint(ctx.checkpoint, device=ctx.device)
    msa = ctx.load_msa()
    scores = score_assay_poet(
        model,
        ctx.mutated_sequences,
        msa.sequences(),
        msa.weights,
        max_context_tokens=int(ctx.extra.get("max_context_tokens", 4096)),
        n_context_samples=int(ctx.extra.get("n_context_samples", 2)),
        batch_size=ctx.batch_size,
    )
    return {"PoET_score": scores}


def _score_focus_model(ctx: ScoreContext, msa, score_fn, mutants,
                       require_alphabet: Optional[str] = None) -> np.ndarray:
    """Remap DMS-coordinate mutants into trimmed-focus coordinates (through
    ``record.MSA_start`` and the MSA's focus columns) and run
    ``score_fn(wt_focus_seq, remapped_mutants)``. Literal wild-type rows
    score 0; a mutant outside the focus columns, with a wrong wild-type
    letter or malformed, is NaN, and so is one whose letters fall outside
    ``require_alphabet`` when given (models with a fixed vocabulary)."""
    msa_start = ctx.record.MSA_start or 1
    col_to_focus = {int(c): i for i, c in enumerate(np.asarray(msa.focus_cols))}
    wt = msa.focus_seq_trimmed.upper()
    remapped, valid = [], []
    for m in mutants:
        if is_wt_row(m):
            remapped.append("")
            valid.append(True)
            continue
        try:
            toks = []
            for f, pos, t in parse_mutant(m):
                fi = col_to_focus[pos - msa_start]
                if wt[fi] != f:
                    raise KeyError(m)
                if require_alphabet is not None and (
                        f not in require_alphabet or t not in require_alphabet):
                    raise KeyError(m)
                toks.append(f"{f}{fi + 1}{t}")
        except (KeyError, ValueError, IndexError):
            valid.append(False)
            continue
        remapped.append(":".join(toks))
        valid.append(True)
    valid = np.asarray(valid, dtype=bool)
    out = np.full(len(mutants), np.nan)
    out[valid] = np.asarray(score_fn(wt, remapped))
    out[[is_wt_row(m) for m in mutants]] = 0.0
    return out


@register_scorer("msa_transformer")
def score_msa_transformer(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """MSA Transformer ensemble masked marginals (ref
    esm/compute_fitness.py:355-400): ``--extra msa_samples=`` rows (384)
    sampled by sequence weight per seed, ``num_seeds=`` seeds (5),
    ``batch_size // 8`` grids per forward. The table is in trimmed
    focus-column coordinates, so mutants are remapped first."""
    from proteingym_tpu_torch.models.msa_transformer import score_assay_msa_transformer
    from proteingym_tpu_torch.pipeline.checkpoints import load_msa_transformer_checkpoint

    model, _ = load_msa_transformer_checkpoint(ctx.checkpoint, device=ctx.device)
    msa = ctx.load_msa()
    scores = _score_focus_model(
        ctx, msa,
        lambda wt, remapped: score_assay_msa_transformer(
            model, wt, remapped, msa.sequences(), msa.weights,
            nseq=int(ctx.extra.get("msa_samples", 384)),
            seeds=tuple(range(1, 1 + int(ctx.extra.get("num_seeds", 5)))),
            chunk=max(1, ctx.batch_size // 8),
        ),
        ctx.mutants,
    )
    return {"esm_msa1b_ensemble": scores}


@register_scorer("tranception")
@register_scorer("trancepteve")
def score_tranception(ctx: ScoreContext):
    """Tranception / TranceptEVE autoregressive scoring (ref
    tranception/score_tranception_proteingym.py, trancepteve/
    score_trancepteve.py), returning the JAX scorer's table:
    ``mutated_sequence, avg_score_L_to_R, avg_score_R_to_L, avg_score``.

    ``--extra retrieval_type=Tranception|TranceptEVE`` fuses the assay's
    MSA prior (and, for TranceptEVE, the EVE prior of
    ``eve_checkpoints=a.pt,b.pt``, reference EVE files, averaged over
    ``eve_num_samples=`` draws, 20,000) into the log-probs; without it the
    model scores alone. With ``--indel-mode`` every sequence is scored
    whole, against priors realigned to it. --checkpoint follows
    load_tranception_checkpoint."""
    from proteingym_tpu_torch.models.trancepteve import (
        RetrievalConfig, build_priors, score_trancepteve,
    )
    from proteingym_tpu_torch.pipeline.checkpoints import (
        load_eve_checkpoint, load_tranception_checkpoint,
    )

    model, _ = load_tranception_checkpoint(ctx.checkpoint, device=ctx.device)
    retrieval_type = ctx.extra.get("retrieval_type")
    rcfg, msa_lp, eve_lp, alpha, beta = None, None, None, 0.0, 0.0
    if retrieval_type:
        msa = ctx.load_msa()
        rcfg = RetrievalConfig(
            retrieval_type=retrieval_type,
            msa_start=ctx.msa_start0,
            msa_end=ctx.record.MSA_end or len(ctx.record.target_seq),
            indel_mode=ctx.indel_mode,
        )
        eve_models = [load_eve_checkpoint(p, device=ctx.device)[0]
                      for p in str(ctx.extra.get("eve_checkpoints") or "").split(",") if p]
        msa_lp, eve_lp, alpha, beta = build_priors(
            msa.sequences(), msa.weights, ctx.record.target_seq, rcfg,
            eve_models=eve_models or None, eve_focus_cols=msa.focus_cols,
            eve_focus_seq=msa.focus_seq_trimmed,
            eve_num_samples=int(ctx.extra.get("eve_num_samples", 20_000)),
        )
    return score_trancepteve(
        model, ctx.mutants, ctx.mutated_sequences, ctx.record.target_seq, rcfg=rcfg,
        msa_log_prior=msa_lp, eve_log_prior=eve_lp, alpha=alpha, beta=beta,
        batch_size=ctx.batch_size, indel_mode=ctx.indel_mode,
    )


# the architectures the eve / deepsequence scorers train without a
# checkpoint: (encoder_hidden, decoder_hidden, z_dim), each overridden by
# --extra of that name
EVE_ARCHITECTURES = {
    "evol_indices": ("2000,1000,300", "300,1000,2000", 50),
    "DeepSequence_evol_indices": ("1500,1500", "100,500", 30),
}


def _score_eve(ctx: ScoreContext, column: str) -> Dict[str, np.ndarray]:
    """Evol indices (ref EVE/compute_evol_indices_DMS.py) over ``--extra
    num_samples=`` draws (2,000) from seed ``seed=`` (42), in the
    alignment's focus coordinates, of the EVE models in ``--checkpoint``
    (comma-separated reference EVE files) or else of models trained from
    the MSA: one per ``--extra seeds=`` (default: ``seed``) for
    ``train_steps=`` steps (10,000), at the scorer's architecture
    (``EVE_ARCHITECTURES``). Several members average into
    ``{column}_ensemble``. Mutants off the focus columns or with a letter
    outside the 20 amino acids are NaN, a literal WT row 0."""
    from proteingym_tpu_torch.models import eve
    from proteingym_tpu_torch.pipeline.checkpoints import load_eve_checkpoint

    msa = ctx.load_msa()
    if ctx.checkpoint:
        members = [load_eve_checkpoint(p, device=ctx.device)[0]
                   for p in str(ctx.checkpoint).split(",")]
    else:
        enc, dec, z_dim = EVE_ARCHITECTURES[column]
        ints = lambda key, default: tuple(int(v) for v in str(ctx.extra.get(key, default)).split(","))
        config = eve.EveConfig(seq_len=msa.seq_len, encoder_hidden=ints("encoder_hidden", enc),
                               decoder_hidden=ints("decoder_hidden", dec),
                               z_dim=int(ctx.extra.get("z_dim", z_dim)))
        seeds = (ints("seeds", None) if ctx.extra.get("seeds")
                 else [int(ctx.extra.get("seed", 42))])
        onehot = msa.one_hot()
        members = [eve.train(onehot, msa.weights, config,
                             steps=int(ctx.extra.get("train_steps", 10_000)), seed=seed,
                             device=ctx.device)
                   for seed in seeds]
    alphabet = eve.ALPHABET
    aa_idx = {a: i for i, a in enumerate(alphabet)}
    # an indeterminate focus letter is an all-zero one-hot row (code -1)
    focus_codes = np.asarray([aa_idx.get(c, -1) for c in msa.focus_seq_trimmed.upper()])
    wt_onehot = eve.onehot_sequence(msa.focus_seq_trimmed)
    num_samples = int(ctx.extra.get("num_samples", 2000))
    seed = int(ctx.extra.get("seed", 42))

    def score_fn(wt, remapped):
        onehots = eve.onehot_mutants(focus_codes, remapped, alphabet)
        return np.mean([eve.evol_indices(m, wt_onehot, onehots, num_samples=num_samples,
                                         seed=seed) for m in members], axis=0)

    scores = _score_focus_model(ctx, msa, score_fn, ctx.mutants, require_alphabet=alphabet)
    return {f"{column}_ensemble" if len(members) > 1 else column: scores}


@register_scorer("eve")
def score_eve(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    return _score_eve(ctx, "evol_indices")


@register_scorer("deepsequence")
def score_deepsequence(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """DeepSequence, EVE's ancestor architecture (a 1500-1500 encoder, z=30,
    a 100-500 decoder), trained and scored by the same recipe."""
    return _score_eve(ctx, "DeepSequence_evol_indices")


# ---------------------------------------------------------------------------
# The autoregressive zoo: absolute mirrored log-likelihoods of whole rows
# ---------------------------------------------------------------------------

# --extra tiny=1: the JAX tests' tiny shapes (head dims 8 and 16), in
# float32; they run on the CPU's plain attention (the card's float32
# kernel takes head dims of 16 and up)
ZOO_TINY = {
    "ProGen2": dict(num_layers=2, embed_dim=64, num_heads=8, rotary_dim=4),
    "RITA": dict(num_layers=2, embed_dim=32, num_heads=4, ffn_dim=64),
    "ProGen3": dict(num_layers=2, hidden_dim=64, num_heads=4, ffn_dim=96, num_experts=4),
}


def _zoo_config(ctx: ScoreContext, presets, default: str, family: str):
    """The preset --checkpoint names (``default`` without one), at
    ``ZOO_TINY[family]``'s shape in float32 with ``--extra tiny=1``."""
    preset = ctx.checkpoint or default
    if preset not in presets:
        raise ValueError(f"Unknown {family} preset {preset}")
    if ctx.extra.get("tiny"):
        return dataclasses.replace(presets[preset], **ZOO_TINY[family], dtype=torch.float32)
    return presets[preset]


def _zoo_columns(ctx: ScoreContext, frame, column: str) -> Dict[str, np.ndarray]:
    """The AR frame left-joined onto the assay's rows on
    ``mutated_sequence`` (the JAX scorers' ``merge(..., how="left")``): the
    L->R and R->L scores, and their mean as ``column``; NaN for a sequence
    the frame lacks."""
    row_of = {s: i for i, s in enumerate(frame["mutated_sequence"])}
    at = np.asarray([row_of.get(s, -1) for s in ctx.mutated_sequences], dtype=np.int64)

    def take(name):  # index -1 reads the NaN appended after the frame's rows
        return np.append(np.asarray(frame[name], dtype=np.float64), np.nan)[at]

    return {"avg_score_L_to_R": take("avg_score_L_to_R"),
            "avg_score_R_to_L": take("avg_score_R_to_L"), column: take("avg_score")}


def _score_zoo(ctx: ScoreContext, logits_fn, tokenize, pad_id: int, n_ctx: int, column: str):
    """``score_mutants_ar`` in its absolute mode (``target_seq=None``: every
    row's summed log-likelihood over sliding windows of ``n_ctx``, mirrored,
    divided by the row's length), as the JAX zoo scorers run it."""
    from proteingym_tpu_torch.models.ar_scoring import score_mutants_ar

    with no_tf32():
        frame = score_mutants_ar(
            logits_fn, tokenize, pad_id=pad_id, mutants=ctx.mutants,
            mutated_sequences=ctx.mutated_sequences, target_seq=None,
            model_context_len=n_ctx, batch_size=ctx.batch_size, device=ctx.device,
        )
    return _zoo_columns(ctx, frame, column)


def _letters(alphabet: str):
    """A tokenizer onto ``alphabet``'s indices, unknown letters as X."""
    index = {c: i for i, c in enumerate(alphabet)}
    return (lambda s: np.asarray([index.get(c, index["X"]) for c in s], np.int64)), index["X"]


@register_scorer("progen2")
def score_progen2(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProGen2 (ref progen2/compute_fitness.py:34-87): the absolute mirrored
    log-likelihood over the amino-acid-restricted logits, in
    ``{config.name}_score`` (the registry merges ``Progen2_score``). The
    preset (--checkpoint, default ``progen2-small``) gets seeded random
    weights; an unknown one raises. ``--extra tiny=1`` runs the preset at
    the tiny float32 shape; a library call may pass a published state dict
    as ``extra["params"]``."""
    from proteingym_tpu_torch.models import ar_zoo

    config = _zoo_config(ctx, ar_zoo.PROGEN2_PRESETS, "progen2-small", "ProGen2")
    state = ctx.extra.get("params")
    model = (ar_zoo.progen2_load_state_dict(state, config, device=ctx.device) if state
             else ar_zoo.progen2_init(config, seed=0, device=ctx.device))
    tokenize, pad = _letters("ABCDEFGHIKLMNOPQRSTUVWXYZ")
    return _score_zoo(ctx, model.restricted_logits, tokenize, pad, config.n_ctx,
                      f"{config.name}_score")


@register_scorer("rita")
def score_rita(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """RITA (ref rita/compute_fitness.py calc_fitness): the absolute mirrored
    log-likelihood in ``{config.name}_score`` (the registry merges
    ``RITA_score``). Presets, ``tiny`` and ``params`` as for ``progen2``
    (default ``RITA_s``)."""
    from proteingym_tpu_torch.models import ar_zoo

    config = _zoo_config(ctx, ar_zoo.RITA_PRESETS, "RITA_s", "RITA")
    state = ctx.extra.get("params")
    model = (ar_zoo.rita_load_state_dict(state, config, device=ctx.device) if state
             else ar_zoo.rita_init(config, seed=0, device=ctx.device))
    tok = ar_zoo.RitaTokenizer()
    return _score_zoo(ctx, model, tok.encode, tok.PAD, config.n_ctx, f"{config.name}_score")


@register_scorer("protgpt2")
def score_protgpt2(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProtGPT2 (ref protgpt2/compute_fitness.py): the absolute mirrored
    log-likelihood in ``ProtGPT2_score``. The shape comes from ``--extra
    num_layers= embed_dim= num_heads=`` (36, 1280, 20) with seeded random
    weights, or from --checkpoint (``load_gpt2_checkpoint``). Tokens are
    the JAX scorer's byte-level fallback, ``ord(c) % vocab_size`` with pad
    0; ``--extra tokenizer=<HF dir>`` reads the real BPE vocabulary
    through ``transformers`` instead, where that is installed."""
    from proteingym_tpu_torch.models import ar_zoo
    from proteingym_tpu_torch.pipeline.checkpoints import load_gpt2_checkpoint

    config = ar_zoo.Gpt2Config(num_layers=int(ctx.extra.get("num_layers", 36)),
                               embed_dim=int(ctx.extra.get("embed_dim", 1280)),
                               num_heads=int(ctx.extra.get("num_heads", 20)))
    state = ctx.extra.get("params")
    if state:
        model = ar_zoo.gpt2_load_state_dict(state, config, device=ctx.device)
    elif ctx.checkpoint:
        model, config = load_gpt2_checkpoint(ctx.checkpoint, config, device=ctx.device)
    else:
        model = ar_zoo.gpt2_init(config, seed=0, device=ctx.device)
    if ctx.extra.get("tokenizer"):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError("--extra tokenizer= reads a BPE vocabulary through the "
                               "transformers package, which is not installed") from e
        hf_tok = AutoTokenizer.from_pretrained(ctx.extra["tokenizer"])
        tokenize = lambda s: np.asarray(hf_tok.encode(s), np.int64)
        pad_id = hf_tok.eos_token_id or 0
    else:
        tokenize = lambda s: np.asarray([ord(c) % config.vocab_size for c in s], np.int64)
        pad_id = 0
    return _score_zoo(ctx, model, tokenize, pad_id, config.n_ctx, "ProtGPT2_score")


@register_scorer("progen3")
def score_progen3(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProGen3 (ref progen3/compute_fitness.py): the absolute mirrored
    log-likelihood over the 26 letters' logits, in ``{config.name}_score``
    (the registry merges ``log_likelihood``). Presets (default
    ``progen3-112m``), ``tiny`` (2 x 64, 4 heads, 4 experts, float32) and
    ``params`` as for ``progen2``; 1,024-token windows."""
    from proteingym_tpu_torch.models import progen3

    config = _zoo_config(ctx, progen3.PRESETS, "progen3-112m", "ProGen3")
    state = ctx.extra.get("params")
    model = (progen3.convert_torch_state_dict(state, config, device=ctx.device) if state
             else progen3.init_random(config, seed=0, device=ctx.device))
    tokenize, pad = _letters("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    return _score_zoo(ctx, model.restricted_logits, tokenize, pad, 1024,
                      f"{config.name}_score")


@register_scorer("unirep")
def score_unirep(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """UniRep (ref unirep/unirep_inference.py, unirep_evotune.py): each
    ``mutated_sequence``'s log-likelihood over its length, in
    ``unirep_score`` (the registry merges ``Unirep_score``). --checkpoint
    is a directory of the published numpy weights; without it, seeded
    random weights at ``--extra hidden_dim=`` (1,900) and ``embed_dim=``
    (10). ``--extra evotune_steps=N`` first finetunes on the assay's
    alignment, rows drawn by sequence weight (K5 or the ``.npy`` cache)."""
    from proteingym_tpu_torch.models import unirep
    from proteingym_tpu_torch.models.ar_scoring import batched_ar_loglik

    config = unirep.UniRepConfig(hidden_dim=int(ctx.extra.get("hidden_dim", 1900)),
                                 embed_dim=int(ctx.extra.get("embed_dim", 10)))
    model = (unirep.convert_tf_weights(ctx.checkpoint, config, device=ctx.device)
             if ctx.checkpoint else unirep.init_params(config, seed=0, device=ctx.device))
    tok = unirep.UniRepTokenizer()
    seqs = ctx.mutated_sequences
    with no_tf32():
        if ctx.extra.get("evotune_steps"):
            msa = ctx.load_msa()
            unirep.evotune(model, msa.sequences(), steps=int(ctx.extra["evotune_steps"]),
                           weights=msa.weights)
        lls = batched_ar_loglik(model, [tok.encode(s) for s in seqs], tok.PAD,
                                batch_size=ctx.batch_size, device=ctx.device)
    return {"unirep_score": lls / np.asarray([len(s) for s in seqs], dtype=np.float64)}


# ---------------------------------------------------------------------------
# The EvolutionaryScale family, xTrimoPGLM and CARP: masked-LM marginals
# ---------------------------------------------------------------------------


def _sdk_shape(state):
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count

    return _block_count(state, "transformer.blocks."), int(np.asarray(state["embed.weight"]).shape[1])


@register_scorer("esmc")
def score_esmc(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ESM-C masked marginals (ref evoscale/compute_fitness.py), or WT
    marginals with ``--extra scoring_strategy=wt-marginals``, in
    ``{config.name}_score`` (the registry merges ``esmc_300M_score`` /
    ``esmc_600M_score``). --checkpoint is a preset (``esmc_tiny``,
    ``esmc_300m`` the default, ``esmc_600m``, ``esm3_open_1.4b_seq``) with
    seeded random weights, or an SDK state dict file, whose preset is found
    by its layers and width; a library call may pass an SDK state dict as
    ``extra["params"]``. A literal WT row scores 0."""
    from proteingym_tpu_torch.models import esmc
    from proteingym_tpu_torch.pipeline.checkpoints import resolve_preset_state

    config, state = resolve_preset_state(
        ctx.checkpoint, esmc.PRESETS, "esmc_300m", "ESM-C", _sdk_shape,
        lambda c: (c.num_layers, c.embed_dim), ctx.extra.get("params"))
    model = (esmc.load_state_dict(state, config, device=ctx.device) if state is not None
             else esmc.init_random(config, seed=0, device=ctx.device))
    with no_tf32():
        scores = esmc.score_assay(model, ctx.record.target_seq, ctx.mutants,
                                  strategy=ctx.extra.get("scoring_strategy", "masked-marginals"),
                                  chunk=ctx.batch_size)
    return {f"{config.name}_score": scores}


@register_scorer("esm3")
def score_esm3(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ESM3 masked marginals, structure-conditioned when the assay has a PDB
    in --structure-dir (ref evoscale/compute_fitness.py:144-470), in
    ``ESM3_score`` (the registry merges ``ESM3_open_score``). --checkpoint:
    ``esm3_tiny`` (the default) or ``esm3_open_small`` with seeded random
    weights, or an esm3-open state dict file; ``extra["params"]`` as for
    ``esmc``. The structure branches follow the JAX scorer: no PDB,
    sequence-only; a PDB and ``--extra structure_checkpoint=`` (a preset,
    seeded random, or a structure-encoder state dict file), that encoder's
    tokens; a PDB with a trunk from a state dict and no
    ``structure_checkpoint=``, a warning and sequence-only (random codes
    would feed noise to real weights); a PDB with a preset trunk, the tiny
    encoder with seeded random weights. A literal WT row scores 0."""
    import warnings

    from proteingym_tpu_torch.models import esm3
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    presets = {**esm3.PRESETS, "esm3_tiny": esm3.TINY}
    config, state = resolve_preset_state(
        ctx.checkpoint, presets, "esm3_tiny", "ESM3",
        lambda sd: (_block_count(sd, "transformer.blocks."),
                    int(np.asarray(sd["encoder.sequence_embed.weight"]).shape[1])),
        lambda c: (c.n_layers, c.d_model), ctx.extra.get("params"))
    model = (esm3.load_state_dict(state, config, device=ctx.device) if state is not None
             else esm3.init_random(config, seed=0, device=ctx.device))
    coords, encoder = None, None
    if ctx.structure_path() is not None:
        coords = _load_structure(ctx)[:, :3]
        sc_spec = ctx.extra.get("structure_checkpoint")
        if sc_spec:
            sc, sc_state = resolve_preset_state(
                sc_spec, esm3.STRUCTURE_ENCODER_PRESETS, "esm3_structure_encoder",
                "ESM3 structure encoder",
                lambda sd: (_block_count(sd, "transformer.blocks."), int(np.asarray(
                    sd["relative_positional_embedding.embedding.weight"]).shape[1])),
                lambda c: (c.n_layers, c.d_model))
            encoder = (esm3.load_structure_encoder_state_dict(sc_state, sc, device=ctx.device)
                       if sc_state is not None
                       else esm3.structure_encoder_init(sc, seed=0, device=ctx.device))
        elif state is not None:
            warnings.warn("esm3: --structure-dir given without --extra structure_checkpoint=; "
                          "scoring sequence-only (random structure-VQ codes would degrade a "
                          "trunk read from a state dict)")
            coords = None
        else:
            encoder = esm3.structure_encoder_init(
                esm3.STRUCTURE_ENCODER_PRESETS["esm3_structure_encoder_tiny"], seed=0,
                device=ctx.device)
    with no_tf32():
        scores = esm3.score_assay_esm3(model, encoder, ctx.record.target_seq, ctx.mutants,
                                       coords=coords, batch=ctx.batch_size)
    return {"ESM3_score": scores}


@register_scorer("xtrimopglm")
def score_xtrimopglm(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """xTrimoPGLM (ref xtrimopglm/compute_fitness.py) over ESM-C's trunk:
    ``--extra mode=mlm`` (the default), the reference's unique-position
    masked marginals, or ``mode=ar``, its chunked CLM delta
    log-likelihood, rows batched ``--batch-size`` a forward; in
    ``xtrimopglm_score`` (the registry merges ``proteinglm-*_{mlm,clm}_score``).
    --checkpoint is a preset (``xtrimopglm_tiny``, ``xtrimopglm_1b`` the
    default, ``xtrimopglm_3b``) with seeded random weights;
    ``extra["params"]`` an SDK-layout (ESM-C) state dict. A mutant the
    recipe cannot parse, a literal WT row among them, is NaN."""
    from proteingym_tpu_torch.models import esmc, xtrimo
    from proteingym_tpu_torch.pipeline.checkpoints import resolve_preset_state

    config, state = resolve_preset_state(ctx.checkpoint, xtrimo.PRESETS, "xtrimopglm_1b",
                                         "xTrimoPGLM", params=ctx.extra.get("params"))
    model = (esmc.load_state_dict(state, config, device=ctx.device) if state is not None
             else esmc.init_random(config, seed=0, device=ctx.device))
    with no_tf32():
        scores = xtrimo.score_assay(model, ctx.record.target_seq, ctx.mutants,
                                    mode=ctx.extra.get("mode", "mlm"), batch_size=ctx.batch_size)
    return {"xtrimopglm_score": scores}


@register_scorer("carp")
def score_carp(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """CARP ByteNet marginals (ref carp_mif/compute_fitness.py), masked or
    with ``--extra scoring_strategy=wt-marginals``, each mutant's sum
    divided by its number of positions, in ``{config.name}_score``.
    --checkpoint is a preset (``carp_600k`` the default, ``carp_38M``,
    ``carp_76M``, ``carp_640M``) with seeded random weights, or a zenodo
    ``carp_*.pt`` file, read natively and run in float32, its preset found
    by its blocks and width; ``extra["params"]`` a state dict in the zenodo
    names, run in the preset's dtype. A literal WT row fails, as in the JAX
    scorer."""
    from proteingym_tpu_torch.models import carp
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    def shape_of(sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        head = sd.get("decoder.conv.weight", sd.get("decoder.weight"))
        return _block_count(sd, "embedder.layers."), int(np.asarray(head).shape[1])

    config, state = resolve_preset_state(
        ctx.checkpoint, carp.CARP_PRESETS, "carp_600k", "CARP", shape_of,
        lambda c: (c.num_layers, c.embed_dim), ctx.extra.get("params"))
    if state is None:
        model = carp.init_random(config, seed=0, device=ctx.device)
    else:
        run_as = config if "params" in ctx.extra else dataclasses.replace(config, dtype=torch.float32)
        model = carp.convert_torch_state_dict(state, run_as, device=ctx.device)
    with no_tf32():
        scores = carp.score_assay(model, ctx.record.target_seq, ctx.mutants,
                                  strategy=ctx.extra.get("scoring_strategy", "masked-marginals"),
                                  chunk=ctx.batch_size)
    return {f"{config.name}_score": scores}
