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
(MLM or AR) and ``carp``, the backbone-conditioned ``esm_if1`` (one chain
or a complex), ``protein_mpnn`` and ``saprot`` (--structure-dir), the
structure-conditioned ``prosst`` (with its GVP quantizer), ``venusrem``,
``mulan``, ``mif`` and ``mif_st`` (--structure-dir), ``protssn`` (an EGNN
ensemble over PLM embeddings), ``s2f`` / ``s3f`` / ``s3f_msa`` (a GVP-GNN
over PLM embeddings, with a surface stream) and ``aido`` (an MoE masked LM
with MSA retrieval), ``vespa`` / ``vespag`` (ProtT5 with VESPA's heads,
VespaG's heads over PLM embeddings), the supervised ``ohe_ridge``,
``embeddings_ridge``, ``proteinnpt`` and ``kermut`` (out-of-fold
predictions per CV scheme, several columns), plus
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
from proteingym_tpu_torch.data.table import Table
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
    assay: Optional[Table] = None  # the assay CSV's columns (DMS_score, fold_*, ...)
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
    follows load_esm_checkpoint. ``--mesh data=N,model=M`` (``extra["mesh"]``)
    scores through ``esm2.ShardedEsm`` on that mesh of the process group:
    the weights tensor-parallel over the model axis (Megatron), each chunk's
    masked rows split over the data axis; every rank of the mesh must run
    the same scorer calls."""
    from proteingym_tpu_torch.models import esm2
    from proteingym_tpu_torch.models.esm_scoring import score_assay
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    specs = (
        str(ctx.extra["ensemble"]).split(",")
        if ctx.extra.get("ensemble") else [ctx.checkpoint]
    )
    mesh = None
    if ctx.extra.get("mesh"):
        from proteingym_tpu_torch.parallel.mesh import mesh_from_spec

        mesh = mesh_from_spec(str(ctx.extra["mesh"]), device=ctx.device)
    per_member = []
    name = None
    for spec in specs:
        model, config = load_esm_checkpoint(spec, device=ctx.device)
        if mesh is not None:
            model = esm2.make_sharded_apply_fn(model, mesh)
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


# ---------------------------------------------------------------------------
# The backbone-conditioned scorers: ESM-IF1, ProteinMPNN and SaProt
# ---------------------------------------------------------------------------


@register_scorer("esm_if1")
def score_esm_if1(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ESM-IF1 inverse folding (ref esm/compute_fitness_esm_if1.py:33-39):
    each ``mutated_sequence``'s mean per-token log-likelihood given the
    assay's backbone in --structure-dir, in ``esm_if1_score`` (the JAX
    scorer's column; the registry merges ``esmif1_ll``). ``--extra
    complex_chains=A,B`` conditions on every named chain of the PDB and
    decodes ``target_chain=`` (A) (the reference's --multichain-backbone).
    --checkpoint is a preset (``esm_if1_tiny`` the default, ``esm_if1``)
    with seeded random weights, or fair-esm's ``esm_if1_gvp4_t16_142M_UR50.pt``,
    its preset found by its encoder layers and width; ``extra["params"]``
    a state dict in fair-esm's names."""
    from proteingym_tpu_torch.data.structures import parse_pdb_backbone
    from proteingym_tpu_torch.models import gvp_transformer as gt
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    config, state = resolve_preset_state(
        ctx.checkpoint, gt.PRESETS, "esm_if1_tiny", "ESM-IF1",
        lambda sd: (_block_count(sd, "encoder.layers."),
                    int(np.asarray(sd["encoder.embed_tokens.weight"]).shape[1])),
        lambda c: (c.encoder_layers, c.encoder_embed_dim), ctx.extra.get("params"))
    model = (gt.load_state_dict(state, config, device=ctx.device) if state is not None
             else gt.init_random(config, seed=0, device=ctx.device))
    chains = ctx.extra.get("complex_chains")
    with no_tf32():
        if chains:
            pdb = ctx.structure_path()
            if pdb is None:
                raise FileNotFoundError(f"No PDB for {ctx.record.DMS_id}")
            coords = {ch: parse_pdb_backbone(pdb, chain=ch)[0][:, :3]
                      for ch in str(chains).split(",")}
            scores = gt.score_sequences_in_complex(
                model, coords, ctx.extra.get("target_chain", "A"), ctx.mutated_sequences,
                batch_size=ctx.batch_size)
        else:
            scores = gt.score_sequences(model, _load_structure(ctx)[:, :3],
                                        ctx.mutated_sequences, batch_size=ctx.batch_size)
    return {"esm_if1_score": scores}


@register_scorer("protein_mpnn")
def score_protein_mpnn(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProteinMPNN (ref protein_mpnn/compute_fitness.py:180-230): each
    ``mutated_sequence``'s -NLL given the backbone in --structure-dir
    (required), averaged over ``--extra num_seq_per_target=`` (10) random
    decoding orders drawn from seed 37, in ``pmpnn_ll``. --checkpoint is
    the preset ``v_48_020`` (the default) with seeded random weights or the
    reference's ``v_48_020.pt``; ``extra["params"]`` a state dict in its
    names."""
    from proteingym_tpu_torch.models import protein_mpnn as mpnn
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    if ctx.structure_dir is None:
        raise FileNotFoundError("protein_mpnn needs --structure-dir")
    config, state = resolve_preset_state(
        ctx.checkpoint, mpnn.PRESETS, "v_48_020", "ProteinMPNN",
        lambda sd: (_block_count(sd, "encoder_layers."),
                    int(np.asarray(sd["W_e.weight"]).shape[0])),
        lambda c: (c.num_encoder_layers, c.hidden_dim), ctx.extra.get("params"))
    model = (mpnn.load_state_dict(state, config, device=ctx.device) if state is not None
             else mpnn.init_random(config, seed=0, device=ctx.device))
    with no_tf32():
        scores = mpnn.score_sequences(model, _load_structure(ctx), ctx.mutated_sequences,
                                      n_orders=int(ctx.extra.get("num_seq_per_target", 10)))
    return {"pmpnn_ll": scores}


@register_scorer("saprot")
def score_saprot(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """SaProt structure-aware masked scoring (ref saprot/compute_fitness.py),
    in ``SaProt_score``: the 3Di letters of the backbone in --structure-dir
    (the port's quantizer, ``ops/tridi.py``), or of ``<DMS_id or
    UniProt_ID>.fasta`` in ``--extra tridi_dir=``; ``vocab_file=`` a
    published vocab.txt. --checkpoint is a preset (``saprot_35M`` the
    default, ``saprot_650M``) with seeded random bf16 weights, or a
    fair-esm-format state dict file, its preset found by its layers and
    width; ``extra["params"]`` a state dict in those names."""
    from proteingym_tpu_torch.models import esm2, saprot
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    config, state = resolve_preset_state(
        ctx.checkpoint, saprot.PRESETS, "saprot_35M", "SaProt",
        lambda sd: (_block_count(sd, "layers."),
                    int(np.asarray(sd["embed_tokens.weight"]).shape[1])),
        lambda c: (c.num_layers, c.embed_dim), ctx.extra.get("params"))
    vocab = None
    if ctx.extra.get("vocab_file"):
        vocab = saprot.SaProtFileVocab(ctx.extra["vocab_file"])
        if vocab.size != config.alphabet_size:
            raise ValueError(f"vocab file has {vocab.size} tokens but the checkpoint's "
                             f"alphabet_size is {config.alphabet_size}")
    model = (esm2.load_fair_esm_state_dict(state, config, device=ctx.device)
             if state is not None else esm2.init_random(config, seed=0, device=ctx.device))
    struc_seq = None
    if ctx.extra.get("tridi_dir"):
        for stem in (ctx.record.DMS_id, ctx.record.UniProt_ID):
            fasta = Path(ctx.extra["tridi_dir"]) / f"{stem}.fasta"
            if fasta.exists():
                with open(fasta) as f:
                    struc_seq = "".join(x.strip() for x in f if not x.startswith(">")).lower()
                break
    coords = None if struc_seq is not None else _load_structure(ctx)
    with no_tf32():
        scores = saprot.score_assay_saprot(model, ctx.record.target_seq, coords, ctx.mutants,
                                           struc_seq=struc_seq, batch_size=ctx.batch_size,
                                           vocab=vocab)
    return {"SaProt_score": scores}


# ---------------------------------------------------------------------------
# The structure-conditioned PLMs: ProSST, VenusREM, MULAN, MIF / MIF-ST
# ---------------------------------------------------------------------------


def _file_in(ctx: ScoreContext, directory, suffix: str) -> Optional[Path]:
    """``directory/<DMS_id or UniProt_ID><suffix>``, the first that exists."""
    for stem in (ctx.record.DMS_id, ctx.record.UniProt_ID):
        path = Path(directory) / f"{stem}{suffix}"
        if path.exists():
            return path
    return None


def _prosst_model(ctx: ScoreContext):
    from proteingym_tpu_torch.models import prosst
    from proteingym_tpu_torch.pipeline.checkpoints import resolve_preset_state

    config, state = resolve_preset_state(
        ctx.checkpoint, prosst.PROSST_PRESETS, "prosst_tiny", "ProSST", prosst.state_shape,
        prosst.config_shape, ctx.extra.get("params"))
    model = (prosst.load_hf_state_dict(state, config, device=ctx.device) if state is not None
             else prosst.init_random(config, seed=0, device=ctx.device))
    return config, model


def _structure_fasta_tokens(ctx: ScoreContext):
    from proteingym_tpu_torch.models import prosst

    sdir = ctx.extra.get("structure_fasta_dir")
    path = _file_in(ctx, sdir, ".fasta") if sdir else None
    return prosst.read_structure_sequence_fasta(path) if path is not None else None


def _quantizer_tokens(ctx: ScoreContext, k_states: int) -> np.ndarray:
    """ProSST's own structure tokens: the GVP encoder of ``quantizer_dir/AE.pt``
    over the backbone, then the nearest of the centroids in
    ``quantizer_centroids=`` or ``quantizer_dir/<K>.npy`` or ``centroids.npy``."""
    from proteingym_tpu_torch.models import prosst_quantizer as pq
    from proteingym_tpu_torch.pipeline.checkpoints import _load_torch_state_dict

    qdir = Path(str(ctx.extra["quantizer_dir"]))
    if (qdir / "params").exists():
        raise ValueError(f"{qdir} holds an orbax params/ directory: those are JAX-only; put "
                         "the vendored AE.pt there")
    if not (qdir / "AE.pt").exists():
        raise FileNotFoundError(f"prosst quantizer_dir {qdir} holds no AE.pt")
    cents = ctx.extra.get("quantizer_centroids")
    if cents is None:
        cents = next((p for p in (qdir / f"{k_states}.npy", qdir / "centroids.npy")
                      if p.exists()), None)
    if cents is None:
        raise FileNotFoundError("prosst quantizer_dir given but no centroids found; pass "
                                "--extra quantizer_centroids=<K.npy>")
    model = pq.load_state_dict(_load_torch_state_dict(qdir / "AE.pt")[0], device=ctx.device)
    return pq.structure_tokens_from_coords(_load_structure(ctx), model, pq.load_centroids(cents))


@register_scorer("prosst")
def score_prosst(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProSST (ref prosst/compute_fitness.py:15-120): WT marginals over the
    residue stream with the structure stream fixed, in ``{preset}_score``
    (the registry merges ``ProSST-{K}``). Structure tokens from ``--extra
    structure_fasta_dir=`` (ProSST's integer FASTAs), else from
    ``quantizer_dir=`` (the vendored ``AE.pt`` GVP encoder and ``{K}.npy``
    or ``centroids.npy`` k-means centroids, or ``quantizer_centroids=``)
    over the backbone in --structure-dir, else the 3Di k-means states.
    --checkpoint is a preset (``prosst_tiny`` the default, ``prosst_{20,
    128, 512, 1024, 2048, 4096}``) with seeded random weights or an HF
    state dict file, its preset found by layers, width and structure
    vocabulary; ``extra["params"]`` an HF-named state dict. ``--extra
    method=additive`` is the legacy scorer: ``esm_checkpoint=``
    (``esm2_t6_8M``) with a ``k_structure=`` (2048) state table, in
    ``ProSST_{k}_score``."""
    from proteingym_tpu_torch.models import prosst

    if ctx.extra.get("method") == "additive":
        from proteingym_tpu_torch.models import esm2

        esm_config = esm2.PRESETS.get(ctx.extra.get("esm_checkpoint", "esm2_t6_8M"),
                                      esm2.PRESETS["esm2_t6_8M"])
        k = int(ctx.extra.get("k_structure", 2048))
        model = prosst.prosst_init(esm_config, k_structure=k, seed=0, device=ctx.device)
        with no_tf32():
            scores = prosst.score_assay_prosst(model, _load_structure(ctx), ctx.record.target_seq,
                                               ctx.mutants, k_structure=k, chunk=ctx.batch_size)
        return {f"ProSST_{k}_score": scores}

    config, model = _prosst_model(ctx)
    seq = ctx.record.target_seq
    k_states = config.ss_vocab_size - 3
    with no_tf32():
        tokens = _structure_fasta_tokens(ctx)
        if tokens is None and ctx.extra.get("quantizer_dir"):
            tokens = _quantizer_tokens(ctx, k_states)
        if tokens is None:
            tokens = prosst.structure_token_ids(_load_structure(ctx), k_states)
        scores = prosst.score_assay_prosst_real(model, seq, tokens[:len(seq)], ctx.mutants)
    return {f"{config.name}_score": scores}


@register_scorer("venusrem")
def score_venusrem(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """VenusREM (ref venusrem/compute_fitness.py): ProSST's WT log-probs
    blended with alignment column distributions, in ``VenusREM_score`` (the
    registry merges ``VenusREM``). The residue alignment from ``--extra
    aa_seq_aln_dir=`` (FASTAs with '>name/a-b' headers), else the assay
    MSA's focus rows when they are as long as the target; the structure
    alignment from ``struc_seq_aln_dir=``; structure tokens as ``prosst``
    finds them without a quantizer; ``alpha=`` (0.8). --checkpoint as for
    ``prosst`` (published: ProSST-2048). ``--extra method=esm`` is the
    legacy ESM blend over ``esm_checkpoint=`` (``esm2_t6_8M``)."""
    from proteingym_tpu_torch.models import prosst

    if ctx.extra.get("method") == "esm":
        from proteingym_tpu_torch.models.structure_plms import venusrem_score_assay
        from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

        model, _ = load_esm_checkpoint(ctx.extra.get("esm_checkpoint", "esm2_t6_8M"),
                                       device=ctx.device)
        seq_aln = None
        if ctx.msa_dir is not None and ctx.record.MSA_filename:
            seq_aln = ctx.load_msa().sequences()
        with no_tf32():
            scores = venusrem_score_assay(model, ctx.record.target_seq, ctx.mutants,
                                          seq_alignment=seq_aln, chunk=ctx.batch_size)
        return {"VenusREM_score": scores}

    config, model = _prosst_model(ctx)
    seq = ctx.record.target_seq
    aa_aln = None
    if ctx.extra.get("aa_seq_aln_dir"):
        path = _file_in(ctx, ctx.extra["aa_seq_aln_dir"], ".fasta")
        aa_aln = prosst.read_alignment_fasta(path) if path is not None else None
    elif ctx.msa_dir is not None and ctx.record.MSA_filename:
        # the assay MSA's focus rows, aligned to the target and of one length
        fseqs = ctx.load_msa().sequences()
        if fseqs and len(fseqs[0]) == len(seq):
            aa_aln = ([f">msa/1-{len(seq)}"], fseqs)
    struct_aln = None
    if ctx.extra.get("struc_seq_aln_dir"):
        path = _file_in(ctx, ctx.extra["struc_seq_aln_dir"], ".fasta")
        struct_aln = prosst.read_alignment_fasta(path) if path is not None else None
    with no_tf32():
        tokens = _structure_fasta_tokens(ctx)
        if tokens is None:
            tokens = prosst.structure_token_ids(_load_structure(ctx), config.ss_vocab_size - 3)
        scores = prosst.venusrem_score_assay_real(
            model, seq, tokens[:len(seq)], ctx.mutants, aa_alignment=aa_aln,
            struct_alignment=struct_aln, alpha=float(ctx.extra.get("alpha", 0.8)))
    return {"VenusREM_score": scores}


@register_scorer("mulan")
def score_mulan(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """MULAN (ref mulan/compute_fitness.py): the masked mutant's probability
    ratio with the backbone's angles in the adapter, in ``MULAN_score``.
    phi and psi come from --structure-dir's backbone, chi1-5 stay at the
    NaN fill, unless ``--extra angles_dir=`` holds ``<DMS_id or
    UniProt_ID>.npy`` (L, 7) radians. --checkpoint is a preset
    (``mulan_tiny`` the default, ``mulan_small``) with seeded random
    weights or a ``StructEsmForMaskedLM`` state dict file, its preset found
    by the trunk's layers and width; ``extra["params"]`` such a state dict.
    ``--batch-size`` mutants a forward. ``--extra method=additive`` is the
    legacy scorer: the ESM2 preset --checkpoint names (``esm2_t6_8M``) with
    a linear dihedral adapter, masked marginals."""
    from proteingym_tpu_torch.models import esm2, mulan
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    if ctx.extra.get("method") == "additive":
        from proteingym_tpu_torch.models.structure_plms import mulan_init, mulan_score_assay

        config = esm2.PRESETS.get(ctx.checkpoint or "esm2_t6_8M", esm2.PRESETS["esm2_t6_8M"])
        model = mulan_init(config, seed=0, device=ctx.device)
        with no_tf32():
            scores = mulan_score_assay(model, _load_structure(ctx), ctx.record.target_seq,
                                       ctx.mutants, chunk=ctx.batch_size)
        return {"MULAN_score": scores}

    config, state = resolve_preset_state(
        ctx.checkpoint, mulan.PRESETS, "mulan_tiny", "MULAN",
        lambda sd: (_block_count(sd, "esm.encoder.layer."),
                    int(np.shape(sd["esm.embeddings.word_embeddings.weight"])[1])),
        lambda c: (c.esm.num_layers, c.esm.embed_dim), ctx.extra.get("params"))
    model = (mulan.load_torch_state_dict(state, config, device=ctx.device) if state is not None
             else mulan.init_random(config, seed=0, device=ctx.device))
    angles = None
    if ctx.extra.get("angles_dir"):
        path = _file_in(ctx, ctx.extra["angles_dir"], ".npy")
        angles = np.load(path) if path is not None else None
    if angles is None:
        angles = mulan.backbone_angle_features(_load_structure(ctx)[:, :3])
    with no_tf32():
        scores = mulan.score_mutants(model, ctx.record.target_seq, angles, ctx.mutants,
                                     batch_size=ctx.batch_size)
    return {"MULAN_score": scores}


def _score_mif(ctx: ScoreContext, variant: str, column: str) -> Dict[str, np.ndarray]:
    from proteingym_tpu_torch.models import structure_plms as sp
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    coords = _load_structure(ctx)
    config, state = resolve_preset_state(
        ctx.checkpoint, sp.MIF_PRESETS, variant, "MIF",
        lambda sd: (_block_count(sd, "embedder.layers."),
                    int(np.shape(sd["decoder.conv.weight"])[1])),
        lambda c: (c.num_layers, c.embed_dim), ctx.extra.get("params"))
    model = (sp.mif_load_state_dict(state, config, device=ctx.device) if state is not None
             else sp.mif_init(config, seed=0, device=ctx.device))
    with no_tf32():
        scores = sp.mif_score_assay(model, coords, ctx.record.target_seq, ctx.mutants)
    return {column: scores}


@register_scorer("mif")
def score_mif(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """MIF masked inverse folding (ref carp_mif/compute_fitness.py:31-48):
    CARP with the backbone's structure features (--structure-dir) added to
    its embeddings, WT marginals over the mutated positions' mean, in
    ``MIF_score`` (the registry merges ``mif_score``). --checkpoint is a
    preset (``mif`` the default: 8 x 256, dilations to 32; ``mif_st``) with
    seeded random weights, or a state dict file in the model's names (its
    preset found by blocks and width); ``extra["params"]`` such a state
    dict. A literal WT row fails, as in the JAX scorer."""
    return _score_mif(ctx, "mif", "MIF_score")


@register_scorer("mif_st")
def score_mif_st(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """MIF-ST: ``mif`` with the sequence-transfer trunk (default preset
    ``mif_st``: 16 x 512, dilations to 64), in ``MIF_ST_score`` (the
    registry merges ``mifst_score``)."""
    return _score_mif(ctx, "mif_st", "MIF_ST_score")


# ---------------------------------------------------------------------------
# Structure slice C: ProtSSN, S2F / S3F / S3F-MSA, AIDO
# ---------------------------------------------------------------------------

PROTSSN_TINY = dict(name="protssn_tiny", input_dim=320, m_dim=32, n_layers=2)


@register_scorer("protssn")
def score_protssn(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProtSSN (ref protssn/compute_fitness.py:53-113): the PLM's final-layer
    embeddings (``--extra esm_checkpoint=``, ``esm2_t6_8M``) through the
    EGNN_Sparse stack over the backbone in --structure-dir, in
    ``ProtSSN_score``, or ``ProtSSN_ensemble`` when --checkpoint is a
    comma-separated list: its members scored one at a time, each freed
    before the next, their scores averaged (an empty entry raises). A member
    is a preset (``protssn_k{10,20,30}_h{512,768,1280}``, ``protssn_tiny``
    the default) with seeded random weights, resized to the PLM's width, or
    a published ``protssn_k{k}_h{h}.pt``, whose k comes from its name (20
    when the name has none) and whose width must be the PLM's. ``--extra
    norm_stats=`` names the ``cath_k{k}_mean_attr.pt`` statistics, one for
    all or one per member; without it the positions are only centred."""
    from proteingym_tpu_torch.models import protssn
    from proteingym_tpu_torch.pipeline.checkpoints import (
        _load_torch_state_dict, load_esm_checkpoint,
    )

    presets = {**protssn.PROTSSN_PRESETS,
               "protssn_tiny": protssn.ProtssnEgnnConfig(**PROTSSN_TINY)}
    specs = [x.strip() for x in str(ctx.checkpoint).split(",")] if ctx.checkpoint else [None]
    if ctx.checkpoint and not all(specs):
        # an empty entry would score a random preset into the average
        raise ValueError(f"empty entry in --checkpoint ensemble list: {ctx.checkpoint!r}")
    stats_spec = ctx.extra.get("norm_stats")
    stats_paths = [x.strip() for x in str(stats_spec).split(",")] if stats_spec else [None]
    if len(stats_paths) == 1:
        stats_paths = stats_paths * len(specs)
    if len(stats_paths) != len(specs):
        raise ValueError(f"{len(specs)} checkpoints but {len(stats_paths)} norm_stats")

    esm_model, esm_config = load_esm_checkpoint(ctx.extra.get("esm_checkpoint", "esm2_t6_8M"),
                                                device=ctx.device)
    coords = _load_structure(ctx)
    seq = ctx.record.target_seq
    with no_tf32():
        emb = protssn.esm_embeddings(esm_model, seq)
    del esm_model
    per_member = []
    for spec, stats_path in zip(specs, stats_paths):
        if spec is None or spec in presets:
            config = presets[spec or "protssn_tiny"]
            if config.input_dim != esm_config.embed_dim:  # a preset takes the PLM's width
                config = dataclasses.replace(config, input_dim=esm_config.embed_dim)
            model = protssn.init_random(config, seed=0, device=ctx.device)
        else:
            path = Path(spec)
            if not path.is_file():
                raise ValueError(f"Unknown ProtSSN checkpoint {spec!r}: not a preset "
                                 f"({sorted(presets)}) and not a file (orbax directories "
                                 "are JAX-only)")
            state, _ = _load_torch_state_dict(path)
            config = protssn.config_from_state_dict(state, protssn.base_config_for_file(path))
            if config.input_dim != esm_config.embed_dim:
                raise ValueError(f"PLM width {esm_config.embed_dim} != EGNN input_dim "
                                 f"{config.input_dim} of {spec}")
            model = protssn.load_state_dict(state, config, device=ctx.device)
        src, dst, edge_attr, pos = protssn.build_calpha_graph(
            coords[:, :3], config.k_neighbors, config.cutoff, config.seq_dist_cut)
        stats = (protssn.load_norm_stats(stats_path) if stats_path
                 else protssn.identity_norm_stats())
        npos, nea = protssn.apply_norm_stats(pos, edge_attr, stats)
        with no_tf32():
            logp = protssn.egnn_log_probs(model, emb, npos, src, dst, nea)
        per_member.append(protssn.score_mutants_egnn(logp, seq, ctx.mutants))
        del model, logp
    column = "ProtSSN_ensemble" if len(specs) > 1 else "ProtSSN_score"
    return {column: np.mean(per_member, axis=0)}


def _surface_inputs(ctx: ScoreContext, pos: np.ndarray, config):
    """``surface_dir/<UniProt_ID or DMS_id>.npz`` (``position``, ``feature``)
    as the surface graph's arrays, or None."""
    from proteingym_tpu_torch.models import s3f

    sdir = ctx.extra.get("surface_dir")
    if not sdir:
        return None
    for stem in (ctx.record.UniProt_ID, ctx.record.DMS_id):
        path = Path(sdir) / f"{stem}.npz"
        if path.exists():
            blob = np.load(path)
            return s3f.build_surface_inputs(blob["position"], blob["feature"], pos, config)
    return None


def _plddt(ctx: ScoreContext, length: int) -> Optional[np.ndarray]:
    """The PDB's per-residue CA B-factors (pLDDT), or None when their count
    is not the sequence's. Read after ``_load_structure``, which has found
    and parsed the same file."""
    from proteingym_tpu_torch.data.structures import parse_pdb_bfactors

    plddt = parse_pdb_bfactors(ctx.structure_path())
    return plddt if len(plddt) == length else None


def _score_s3f(ctx: ScoreContext, variant: str) -> Dict[str, np.ndarray]:
    from proteingym_tpu_torch.models import esm2, s3f
    from proteingym_tpu_torch.models.structure_plms import AA20, alignment_count_logits
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint, resolve_preset_state

    use_surface = variant != "s2f"
    config, state = resolve_preset_state(
        ctx.checkpoint, s3f.S3F_PRESETS, "s3f_tiny" if use_surface else "s2f_tiny", "S3F",
        s3f.state_shape, s3f.config_shape, ctx.extra.get("params"))
    esm_model, esm_config = load_esm_checkpoint(ctx.extra.get("esm_checkpoint", "esm2_t6_8M"),
                                                device=ctx.device)
    coords = _load_structure(ctx)
    if esm_config.embed_dim != config.node_in:
        if state is not None:
            raise ValueError(f"PLM width {esm_config.embed_dim} != checkpoint node_in "
                             f"{config.node_in}")
        config = dataclasses.replace(config, node_in=esm_config.embed_dim)
    model = (s3f.load_state_dict(state, config, device=ctx.device) if state is not None
             else s3f.init_random(config, seed=0, device=ctx.device))
    seq = ctx.record.target_seq
    tokens = torch.as_tensor(esm2.ALPHABET.tokenize(seq)[None], device=ctx.device)
    with no_tf32(), torch.no_grad():
        # one forward: the embeddings and the ESM logits in the head's order
        logits, reps = esm_model(tokens, return_representations=True)
    del esm_model
    emb = reps[max(reps)][0, 1:1 + len(seq)].float()
    cols = [esm2.ALPHABET.get_idx(a) for a in s3f.TD_RESIDUES]
    esm20 = logits[0, 1:1 + len(seq)][:, cols].float().cpu().numpy()
    pos = coords[:, 1].astype(np.float32)  # CA
    src, dst = s3f.radius_graph(pos, config.radius)
    surface = _surface_inputs(ctx, pos, config) if use_surface else None
    with no_tf32():
        node_logits = s3f.gvpgnn_node_logits(model, emb, pos, src, dst, surface=surface)
    scores = s3f.score_mutants_gvpgnn(node_logits, esm20, _plddt(ctx, len(seq)), seq,
                                      ctx.mutants)
    if variant == "s3f_msa":
        msa_seqs = ctx.load_msa().sequences()
        if msa_seqs and len(msa_seqs[0]) == len(seq):
            scores = scores + s3f.score_table(alignment_count_logits(msa_seqs),
                                              {a: i for i, a in enumerate(AA20)}, seq,
                                              ctx.mutants)
    return {{"s2f": "S2F_score", "s3f": "S3F_score", "s3f_msa": "S3F_MSA_score"}[variant]: scores}


@register_scorer("s2f")
def score_s2f(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """S2F (ref S3F/s3f/gvp.py, task.py, script/evaluate.py): the PLM's
    final-layer features (``--extra esm_checkpoint=``, ``esm2_t6_8M``)
    through the GVP-GNN over the 10 A CA graph of --structure-dir's
    backbone, the rows whose PDB B-factor (pLDDT) is under 70 taking the
    PLM's own logits, in ``S2F_score``. --checkpoint is a preset
    (``s2f_tiny`` the default, ``s2f``; seeded random weights, resized to
    the PLM's width) or a published file, its preset found by layers,
    widths and surface stream; ``extra["params"]`` a state dict in the
    published names. WT rows score 0."""
    return _score_s3f(ctx, "s2f")


@register_scorer("s3f")
def score_s3f(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """S3F: ``s2f`` with the surface stream over ``--extra surface_dir=``'s
    ``<UniProt_ID or DMS_id>.npz`` (``position`` (S, 3), ``feature`` (S,
    42)); without one it runs structure-only. Default preset ``s3f_tiny``;
    ``s3f`` is the published width. In ``S3F_score``."""
    return _score_s3f(ctx, "s3f")


@register_scorer("s3f_msa")
def score_s3f_msa(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """S3F-MSA: ``s3f`` plus the alignment's count prior (log p(mt) - log
    p(wt) of its columns) when the MSA's first row is as long as the
    target, in ``S3F_MSA_score``; needs the assay's MSA."""
    return _score_s3f(ctx, "s3f_msa")


@register_scorer("aido")
def score_aido(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """AIDO-class MoE masked LM with MSA retrieval (ref AIDO/compute_fitness.py),
    ``AidoConfig()`` on seeded random weights, ``--batch-size`` masked grids
    a forward, the assay's alignment and its weights blended in when it has
    one, in ``AIDO_score``. A literal WT row fails, as in the JAX scorer."""
    from proteingym_tpu_torch.models import structure_plms as sp

    config = sp.AidoConfig()
    model = sp.aido_init(config, seed=0, device=ctx.device)
    msa_seqs = msa_w = None
    if ctx.msa_dir is not None and ctx.record.MSA_filename:
        msa = ctx.load_msa()
        msa_seqs, msa_w = msa.sequences(), msa.weights
    with no_tf32():
        scores = sp.aido_score_assay(model, ctx.record.target_seq, ctx.mutants,
                                     msa_sequences=msa_seqs, msa_weights=msa_w,
                                     chunk=ctx.batch_size)
    return {"AIDO_score": scores}


# ---------------------------------------------------------------------------
# The VESPA family and the supervised track
# ---------------------------------------------------------------------------


def _torch_file_state(spec, family: str, weights_name: str = "pytorch_model.bin"):
    """The state dict of a published torch file, or of ``weights_name`` in a
    directory; an orbax ``params/`` directory (JAX-only) raises."""
    from proteingym_tpu_torch.pipeline.checkpoints import _load_torch_state_dict

    path = Path(str(spec))
    if path.is_dir():
        if (path / "params").exists():
            raise ValueError(f"{spec} holds an orbax params/ directory: those are JAX-only; "
                             f"pass the published {family} torch file")
        path = path / weights_name
    if not path.is_file():
        raise FileNotFoundError(f"{family} checkpoint {spec!r}: no such file")
    return _load_torch_state_dict(path)[0]


def _load_prot_t5(ctx: ScoreContext):
    """ProtT5 from ``extra["params"]`` (an HF-named state dict) or from
    ``--extra prot_t5_checkpoint=`` (an HF ``pytorch_model.bin`` or a
    directory holding one)."""
    from proteingym_tpu_torch.models import prot_t5

    state = ctx.extra.get("params")
    if state is None:
        state = _torch_file_state(ctx.extra["prot_t5_checkpoint"], "ProtT5")
    return prot_t5.load_state_dict(state, device=ctx.device)


def _plm_embeddings(ctx: ScoreContext, wt: str):
    """(L, D) per-residue trunk embeddings for the VESPA-class heads, and D:
    ProtT5's with ``--extra prot_t5_checkpoint=``, else the ESM2 trunk of
    ``esm_checkpoint=`` (``esm2_t6_8M``; VespaG's published trunk is
    ``esm2_t36_3B``)."""
    from proteingym_tpu_torch.models import prot_t5, protssn
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    with no_tf32():
        if ctx.extra.get("prot_t5_checkpoint"):
            model = prot_t5.load_state_dict(
                _torch_file_state(ctx.extra["prot_t5_checkpoint"], "ProtT5"), device=ctx.device)
            return prot_t5.embeddings(model, wt), model.config.d_model
        model, config = load_esm_checkpoint(ctx.extra.get("esm_checkpoint", "esm2_t6_8M"),
                                            device=ctx.device)
        return protssn.esm_embeddings(model, wt), config.embed_dim


@register_scorer("vespag")
@register_scorer("vespa")
def score_vespag(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """VESPA and VespaG, one scorer under both names as in the JAX package.

    ``--extra vespa_mode=full|light``: VESPA / VESPAl (Marquet et al. 2022),
    ProtT5's embeddings through the ConsCNN (``conscnn_checkpoint=``, a
    ``prott5cons`` .pt), BLOSUM62 and, in ``full``, ProtT5's masked
    log-odds through the logistic blend (``vespa_blend=`` JSON {"w", "b"},
    ``DEFAULT_BLEND`` without it), then the reference's sum of log(1 - p),
    in ``VESPA_score``. ``vespa_mode=logodds``: the masked log-odds alone
    (sum of log p(mt) - log p(wt)). ProtT5 is ``prot_t5_checkpoint=`` (an HF
    T5ForConditionalGeneration ``pytorch_model.bin`` or its directory), or
    for a library call ``extra["params"]``.

    Otherwise VespaG in ``VespaG_score``: with --checkpoint (the published
    ``state_dict_v2.pt``; ``extra["params"]`` its state dict) the head over
    the trunk's embeddings (``esm_checkpoint=``, or ProtT5's), the reference's
    masked landscape summed per mutant with a sigmoid (``normalize=0`` off);
    without one a seeded FNN head distilled from GEMME's table of the
    assay's MSA (``train_steps=`` 200 Adam steps), scored in focus
    coordinates (mutants off the focus columns NaN, a literal WT row 0)."""
    from proteingym_tpu_torch.models import gemme, prot_t5, vespa_heads, vespag

    mode = str(ctx.extra.get("vespa_mode", ""))
    wt = ctx.record.target_seq
    has_t5 = ctx.extra.get("params") is not None or ctx.extra.get("prot_t5_checkpoint")
    if mode in ("full", "light", "logodds") and not has_t5:
        raise ValueError(f"vespa_mode={mode} needs --extra prot_t5_checkpoint=<HF "
                         "T5ForConditionalGeneration pytorch_model.bin or its directory>")
    if mode in ("full", "light"):
        cc = ctx.extra.get("conscnn_checkpoint")
        if not cc:
            raise ValueError("vespa_mode=full/light needs --extra conscnn_checkpoint=<the "
                             "prott5cons .pt>")
        model = _load_prot_t5(ctx)
        cnn = vespa_heads.load_conscnn_state_dict(_torch_file_state(cc, "ConsCNN"),
                                                  device=ctx.device)
        with no_tf32():
            cons = vespa_heads.conservation_probs(cnn, prot_t5.embeddings(model, wt))
            logodds = None
            if mode == "full":
                table = prot_t5.masked_logodds(model, wt)
                logodds = table[:, [prot_t5.AA_TOKEN_IDS[a] for a in vespa_heads.AA20]]
        blend = None
        if ctx.extra.get("vespa_blend"):
            import json

            raw = json.loads(Path(ctx.extra["vespa_blend"]).read_text())
            blend = {"w": np.asarray(raw["w"], np.float32), "b": float(raw["b"])}
        effect = vespa_heads.vespa_table(wt, cons, logodds, blend)
        return {"VESPA_score": vespa_heads.score_mutants(effect, wt, ctx.mutants)}
    if mode == "logodds":
        model = _load_prot_t5(ctx)
        with no_tf32():
            table = prot_t5.masked_logodds(model, wt)
        ids = prot_t5.AA_TOKEN_IDS
        scores = np.zeros(len(ctx.mutants))
        for i, m in enumerate(ctx.mutants):
            if is_wt_row(m):
                continue
            for tok in str(m).split(":"):
                w, pos, mt = tok[0], int(tok[1:-1]) - 1, tok[-1]
                if wt[pos] != w:
                    raise ValueError(f"WT mismatch in {tok}")
                scores[i] += table[pos, ids[mt]] - table[pos, ids[w]]
        return {"VESPA_score": scores}

    if ctx.checkpoint or ctx.extra.get("params") is not None:
        state = ctx.extra.get("params")
        if state is None:
            state = _torch_file_state(ctx.checkpoint, "VespaG", "state_dict_v2.pt")
        head = vespag.load_state_dict(state, device=ctx.device)
        emb, _ = _plm_embeddings(ctx, wt)
        with no_tf32():
            table = vespag.landscape(head, emb)
        normalize = str(ctx.extra.get("normalize", "1")) not in ("0", "false", "False")
        return {"VespaG_score": vespag.score_mutants_reference(table, wt, ctx.mutants,
                                                               normalize=normalize)}

    msa = ctx.load_msa()
    teacher = gemme.fit_gemme(msa.matrix, msa.weights, device=ctx.device)
    focus_wt = msa.focus_seq_trimmed.upper()
    emb, embed_dim = _plm_embeddings(ctx, focus_wt)
    with no_tf32():
        head = vespag.train_from_teacher(vespag.init_fnn(embed_dim, seed=0, device=ctx.device),
                                         emb, teacher.combined(),
                                         steps=int(ctx.extra.get("train_steps", 200)))
        scores = _score_focus_model(
            ctx, msa, lambda wt_seq, remapped: vespag.score_mutants(head, emb, wt_seq, remapped),
            ctx.mutants)
    return {"VespaG_score": scores}


SUPERVISED_PREFIX = {"ohe_ridge": "OHE_ridge", "embeddings_ridge": "Emb_ridge",
                     "proteinnpt": "ProteinNPT"}


def _score_supervised(ctx: ScoreContext, name: str) -> Dict[str, np.ndarray]:
    """Out-of-fold predictions per CV scheme of the assay's ``DMS_score``
    (published ``fold_*`` columns when the assay has them), one column
    ``{OHE_ridge|Emb_ridge|ProteinNPT}[_aug]_{scheme}`` each. The
    'Augmented' ridges take a zero-shot column from ``--extra aug_col=`` (a
    column of the assay) or ``aug_file=`` (a scores CSV joined on mutant,
    ``aug_file_col=`` or its last non-key column); ``lam=`` (1.0)."""
    from proteingym_tpu_torch.models.supervised_baselines import (
        load_aug_scores, make_embedding_feature_fn, run_supervised_baseline,
    )

    if ctx.assay is None:
        raise ValueError(f"{name} needs the assay table (DMS_score and the fold columns)")
    aux = None
    if ctx.extra.get("aug_col"):
        aux = ctx.assay.floats(ctx.extra["aug_col"])
    elif ctx.extra.get("aug_file"):
        aux = load_aug_scores(ctx.assay["mutant"].tolist(), ctx.extra["aug_file"],
                              ctx.extra.get("aug_file_col"))
    feature_fn, model, npt_config = None, "OHE_ridge", None
    if name == "embeddings_ridge":
        model = "embeddings_ridge"
        feature_fn = make_embedding_feature_fn(ctx.checkpoint, batch_size=ctx.batch_size,
                                               device=ctx.device)
    elif name == "proteinnpt":
        from proteingym_tpu_torch.models.protein_npt import ProteinNptConfig

        model = "ProteinNPT"
        if any(k in ctx.extra for k in ("npt_steps", "npt_layers", "npt_dim")):
            defaults = ProteinNptConfig()
            npt_config = ProteinNptConfig(
                steps=int(ctx.extra.get("npt_steps", defaults.steps)),
                num_layers=int(ctx.extra.get("npt_layers", defaults.num_layers)),
                embed_dim=int(ctx.extra.get("npt_dim", defaults.embed_dim)))
    with no_tf32():
        results = run_supervised_baseline(ctx.assay, ctx.record.target_seq, model=model,
                                          lam=float(ctx.extra.get("lam", 1.0)),
                                          feature_fn=feature_fn, aux=aux, npt_config=npt_config,
                                          device=ctx.device)
    prefix = SUPERVISED_PREFIX[name] + ("_aug" if aux is not None and name != "proteinnpt"
                                        else "")
    return {f"{prefix}_{scheme}": table["y_pred"] for scheme, table in results.items()}


@register_scorer("ohe_ridge")
def score_ohe_ridge(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """The one-hot ridge (``_score_supervised``)."""
    return _score_supervised(ctx, "ohe_ridge")


@register_scorer("embeddings_ridge")
def score_embeddings_ridge(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """The embedding ridge: each ``mutated_sequence``'s mean-pooled final-layer
    ESM embedding (--checkpoint, an ESM spec; ``esm2_t6_8M`` without one),
    BOS and EOS in the mean (``_score_supervised``)."""
    return _score_supervised(ctx, "embeddings_ridge")


@register_scorer("proteinnpt")
def score_proteinnpt(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ProteinNPT, one model per fold from seed 42 + fold, its auxiliary
    token the assay's ``zero_shot_score`` / ``Tranception_score`` when it has
    one; ``--extra npt_steps= npt_layers= npt_dim=`` (600, 2, 48)
    (``_score_supervised``)."""
    return _score_supervised(ctx, "proteinnpt")


KERMUT_MPNN = dict(name="kermut_probs", hidden_dim=64, edge_features=64, k_neighbors=16)


@register_scorer("kermut")
def score_kermut(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """Kermut's GP (ref kermut/proteingym_benchmark.py) per CV scheme, in
    ``kermut_{scheme}``: the mutation kernel over the backbone in
    --structure-dir and the conditionals of a seeded ProteinMPNN
    (``KERMUT_MPNN``) averaged over ``--extra n_orders=`` (2) decoding
    orders; per fold ``gp_steps=`` (50) Adam steps on the marginal
    likelihood, then the posterior mean."""
    from proteingym_tpu_torch.models import kermut
    from proteingym_tpu_torch.models import protein_mpnn as mpnn
    from proteingym_tpu_torch.data.table import parse_numeric
    from proteingym_tpu_torch.models.supervised_baselines import CV_SCHEMES, assign_folds

    if ctx.assay is None:
        raise ValueError("kermut needs the assay table (DMS_score and the fold columns)")
    coords = _load_structure(ctx)
    model = mpnn.init_random(mpnn.MpnnConfig(**KERMUT_MPNN), seed=0, device=ctx.device)
    steps = int(ctx.extra.get("gp_steps", 50))
    with no_tf32():
        probs = kermut.conditional_probs_from_mpnn(model, coords, ctx.record.target_seq,
                                                   n_orders=int(ctx.extra.get("n_orders", 2)))
        data = kermut.KermutData.build(probs, coords[:, 1])
        tables = kermut.DeviceTables(data, ctx.device)
        enc = kermut.encode_variants(ctx.mutants)
        y = ctx.assay.floats("DMS_score")
        out = {}
        for scheme in CV_SCHEMES:
            folds = (parse_numeric(ctx.assay[scheme]) if scheme in ctx.assay
                     else assign_folds(ctx.mutants, scheme))
            preds = np.zeros(len(y))
            for fold in np.unique(folds):
                test = folds == fold
                train = tuple(t[~test] for t in enc)
                hypers = kermut.fit(data, train, y[~test], steps=steps, tables=tables)
                preds[test] = kermut.predict(hypers, data, train, y[~test],
                                             tuple(t[test] for t in enc), tables=tables)
            out[f"kermut_{scheme}"] = preds
    return out
