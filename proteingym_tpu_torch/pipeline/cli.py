"""Command line of the PyTorch port (counterpart of
proteingym_tpu/pipeline/cli.py for ``score --model esm|poet|msa_transformer|
tranception|trancepteve|eve|deepsequence|site_independent|potts|evmutation|
hmm|wavenet|gemme|escott|siterm|rsalor|provean|progen2|rita|protgpt2|
progen3|unirep`` and every later scorer (``models`` lists the 45),
``score --checkpoint-root``, ``score --mesh``, ``score --profile-dir``,
``train --model eve|potts``, ``weights``, ``merge``, ``evaluate``,
``evaluate-clinical``, ``supervised-score``, ``merge-supervised``,
``evaluate-supervised``, ``download`` and ``models``).

    python -m proteingym_tpu_torch.pipeline.cli score --model esm \\
        --checkpoint esm2_t33_650M --dms-reference ref.csv --dms-dir dms/ \\
        --output-dir out/ [--device cuda|cpu] [--packed]
    python -m proteingym_tpu_torch.pipeline.cli score --model poet \\
        --checkpoint poet_200m --msa-dir msa/ --weights-dir weights/ \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/
    python -m proteingym_tpu_torch.pipeline.cli score --model msa_transformer \\
        --checkpoint esm_msa1b_t12_100M --msa-dir msa/ --weights-dir weights/ \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/ \\
        [--extra msa_samples=384 num_seeds=5]
    python -m proteingym_tpu_torch.pipeline.cli score --model trancepteve \\
        --checkpoint Large --msa-dir msa/ --weights-dir weights/ \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/ \\
        --extra retrieval_type=TranceptEVE eve_checkpoints=eve.pt
    python -m proteingym_tpu_torch.pipeline.cli score --model trancepteve \\
        --indel-mode --checkpoint Large --msa-dir msa/ --weights-dir weights/ \\
        --dms-reference indels.csv --dms-dir dms_indels/ --output-dir out/ \\
        --extra retrieval_type=TranceptEVE eve_checkpoints=eve.pt
    python -m proteingym_tpu_torch.pipeline.cli score --model hmm|potts|site_independent \\
        --msa-dir msa/ --weights-dir weights/ --dms-reference ref.csv \\
        --dms-dir dms/ --output-dir out/ [--indel-mode] [--checkpoint X.model]
    python -m proteingym_tpu_torch.pipeline.cli score --model eve|deepsequence \\
        [--checkpoint eve.pt] --msa-dir msa/ --weights-dir weights/ \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/ \\
        [--extra train_steps=10000 seeds=1,2,3]
    python -m proteingym_tpu_torch.pipeline.cli score --model wavenet \\
        --msa-dir msa/ --weights-dir weights/ --dms-reference ref.csv \\
        --dms-dir dms/ --output-dir out/ [--extra steps=400]
    python -m proteingym_tpu_torch.pipeline.cli score --model gemme|escott|siterm|rsalor|provean \\
        --msa-dir msa/ --weights-dir weights/ --dms-reference ref.csv \\
        --dms-dir dms/ --output-dir out/ [--structure-dir pdbs/] \\
        [--extra method=f81]
    python -m proteingym_tpu_torch.pipeline.cli score --model progen2|rita|progen3 \\
        --checkpoint progen2-xlarge --dms-reference ref.csv --dms-dir dms/ \\
        --output-dir out/ [--extra tiny=1]
    python -m proteingym_tpu_torch.pipeline.cli score --model protgpt2|unirep \\
        [--checkpoint DIR] --dms-reference ref.csv --dms-dir dms/ --output-dir out/ \\
        [--msa-dir msa/ --weights-dir weights/ --extra evotune_steps=100]
    python -m proteingym_tpu_torch.pipeline.cli train --model eve|potts \\
        --msa-dir msa/ --weights-dir weights/ --dms-reference ref.csv \\
        --dms-id X --output-dir models/ [--steps 400000] [--seed 0]
    python -m proteingym_tpu_torch.pipeline.cli weights --msa X.a2m \\
        --theta 0.2 --output weights/X.npy [--device cuda|cpu]
    python -m proteingym_tpu_torch.pipeline.cli merge --dms-reference ref.csv \\
        --dms-dir dms/ --scores-root scores/ --config config.json --output-dir merged/
    python -m proteingym_tpu_torch.pipeline.cli evaluate --dms-reference ref.csv \\
        --merged-dir merged/ --config config.json --output-dir bench/ [--device cuda|cpu]
    python -m proteingym_tpu_torch.pipeline.cli evaluate-clinical \\
        --clinical-reference clinical.csv --merged-dir merged/ --output-dir bench/
    python -m proteingym_tpu_torch.pipeline.cli score --model vespa \\
        --extra vespa_mode=full prot_t5_checkpoint=t5/ conscnn_checkpoint=cons.pt \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/
    python -m proteingym_tpu_torch.pipeline.cli score --model vespag \\
        --checkpoint state_dict_v2.pt --extra esm_checkpoint=esm2_t36_3B \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/
    python -m proteingym_tpu_torch.pipeline.cli score --model ohe_ridge|embeddings_ridge|proteinnpt|kermut \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir out/ [--structure-dir pdbs/]
    python -m proteingym_tpu_torch.pipeline.cli supervised-score --model OHE_ridge \\
        --dms-reference ref.csv --dms-dir dms/ --output-dir scores_root/
    python -m proteingym_tpu_torch.pipeline.cli merge-supervised --dms-reference ref.csv \\
        --dms-dir dms/ --scores-root scores_root/ --config config.json --output-dir merged/
    python -m proteingym_tpu_torch.pipeline.cli evaluate-supervised --dms-reference ref.csv \\
        --input-scoring-file merged/merged_scores_substitutions_DMS.csv --output-dir bench/
    python -m proteingym_tpu_torch.pipeline.cli models
    python -m proteingym_tpu_torch.pipeline.cli download [--list] \\
        [--resources DMS_ProteinGym_substitutions ...] [--cache DIR]
    torchrun --nproc-per-node 4 -m proteingym_tpu_torch.pipeline.cli score \\
        --model esm --checkpoint esm2_t36_3B --mesh data=2,model=2 ...

Per assay it writes ``<DMS_id>.csv`` (the input columns, plus
``mutated_sequence`` when absent, plus the score column; for Tranception
the scorer's own table, ``mutated_sequence`` and the L->R, R->L and mean
scores) into the output directory, with ``manifest.jsonl`` (done/failed
per task, for resuming) and ``events.jsonl`` (phase timings and
throughput) beside it. With
``--packed`` (ESM masked marginals) the masked rows of all selected assays
share forward batches; the batch is one ``score_packed`` phase and fails
or succeeds as a whole. ``--extra scoring_strategy=wt-marginals|pseudo-ppl``
selects the other ESM strategies (per assay only). ``--mesh data=N,model=M``
scores ESM through a (data, model) mesh of the process group (torchrun's,
or a world of one): every rank runs the command, rank 0 alone writes the
CSVs, the manifest and the event log; ``--packed`` refuses a mesh, and so
does ``--extra`` (the mesh is ``--mesh``'s alone).
``--profile-dir DIR`` wraps the scoring in ``torch.profiler`` and writes its
Chrome trace (``DIR/<host>_<pid>.<ms>.pt.trace.json``) when the run ends.

``train`` trains one assay's alignment model and writes it to
``<output-dir>/<model>_<DMS_id>_seed<seed>``: for ``eve`` a reference EVE
checkpoint file (``torch.save`` of ``eve.checkpoint_dict``, which
``score --checkpoint`` and ``eve_checkpoints=`` read; the JAX CLI writes
an orbax directory there instead), for ``potts`` a plmc ``.model`` file
beside that stem.

``--structure-dir`` holds ``<UniProt_ID>.pdb`` or ``<DMS_id>.pdb`` per
assay, which ``escott``, ``rsalor`` and ``esm3`` read when it is there. ``models``
prints the scorer names, sorted, one per line. ``--checkpoint-root DIR``
routes each assay to its own checkpoint, ``DIR/<EVE_model_path>`` of its
reference row (the clinical reference's column); an assay without one is
skipped (``task_missing_input``).

``supervised-score`` writes each CV scheme's out-of-fold predictions of a
supervised baseline (``OHE_ridge``, ``embeddings_ridge``, ``ProteinNPT``) as
``<output-dir>/<scheme>/<model>/<DMS_id>.csv`` (mutant, y_pred, DMS_score),
the layout ``merge-supervised`` reads; it joins them per scheme, writes the
merged files and the long ``merged_scores_<type>_DMS.csv`` (Spearman and MSE
per assay, model and scheme, computed on ``--device``), which
``evaluate-supervised`` turns into the supervised leaderboards on the host.

``download`` fetches the published ProteinGym v1.1 archives, checks each
one's SHA256 and unzips it under ``--cache`` (``PROTEINGYM_CACHE``, else
``~/.cache/proteingym_tpu``); an archive already in the cache with the
right hash is used without the network, and ``--list`` prints the table.

``merge`` joins each model's score files onto the assays and runs on the
host; ``evaluate`` and ``evaluate-clinical`` write the JAX package's metric
CSVs with the per-assay metrics computed on ``--device``. Without
``--config`` the port's packaged registry is read.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import sys
import time
from pathlib import Path

import numpy as np

from proteingym_tpu_torch.data.mutants import apply_mutant
from proteingym_tpu_torch.data.reference import load_reference
from proteingym_tpu_torch.data.table import NA_STRINGS, Table, write_csv
from proteingym_tpu_torch.devices import no_tf32, resolve_device
from proteingym_tpu_torch.pipeline.manifest import Manifest
from proteingym_tpu_torch.pipeline.profiler import Throughput, trace
from proteingym_tpu_torch.pipeline.scorers import (
    SCORERS, ScoreContext, score_esm_packed_batch,
)
from proteingym_tpu_torch.pipeline.telemetry import EventLog


def _parse_extra(pairs):
    out = {}
    for pair in pairs or []:
        k, _, v = pair.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except (TypeError, ValueError):
                continue
        out[k] = v
    return out


def _load_registry_arg(config_path, dataset, mutation_type, constants_path=None):
    """--config points at a ProteinGym-format config.json; without it the
    port's packaged registry (proteingym_tpu_torch/configs/registry.json)
    is read."""
    from proteingym_tpu_torch.data.registry import load_packaged_registry, load_registry

    if config_path:
        return load_registry(config_path, dataset=dataset, mutation_type=mutation_type,
                             constants_path=constants_path)
    return load_packaged_registry(dataset, mutation_type)


def _read_csv(path: Path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return list(reader.fieldnames or []), rows


def _score_table(columns, rows, scores) -> Table:
    """What the CLI writes for an assay: a scorer's own ``Table`` as it is,
    else the input columns plus one float column per score array. A NaN
    score is an empty field, as pandas ``to_csv`` writes it in the JAX
    CLI."""
    if isinstance(scores, Table):
        return scores
    table = Table({c: [row[c] for row in rows] for c in columns}, n_rows=len(rows))
    for name, values in scores.items():
        table[name] = np.asarray(values, dtype=np.float64)
    return table


def cmd_score(args) -> int:
    if args.model not in SCORERS:
        print(f"Unknown model '{args.model}'. Available: {sorted(SCORERS)}")
        return 2
    device = resolve_device(args.device)
    reference = load_reference(args.dms_reference)
    if args.dms_id:
        records = [reference[args.dms_id]]
    elif args.dms_index is not None:
        records = [reference[args.dms_index]]
    else:
        records = list(reference)

    extra = _parse_extra(args.extra)
    if "mesh" in extra:
        print("give the mesh as --mesh SPEC, not in --extra")
        return 2
    rank = 0
    if args.mesh:  # every rank runs the same calls; rank 0 alone writes
        from proteingym_tpu_torch.parallel.mesh import launch_rank

        extra["mesh"] = args.mesh
        rank = launch_rank()
    writer = rank == 0
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    log = EventLog(output_dir / "events.jsonl" if writer else None,
                   echo=writer and not args.quiet)
    manifest = Manifest(output_dir / "manifest.jsonl", read_only=not writer)
    throughput = Throughput(event_log=log)
    profile_ctx = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    if args.packed:
        return _cmd_score_packed(args, records, output_dir, log, manifest, device, extra,
                                 throughput, profile_ctx)
    with profile_ctx:
        failures = _score_records(args, records, output_dir, log, manifest, device, extra,
                                  throughput, writer)
    if throughput.total_mutants:
        log.emit("throughput_summary", **throughput.summary())
    return 1 if failures else 0


def _score_records(args, records, output_dir, log, manifest, device, extra, throughput,
                   writer) -> int:
    """Score each assay on its own (per-assay isolation); returns the
    number that failed."""
    scorer = SCORERS[args.model]
    failures = 0
    for rec in records:
        task = f"{args.model}/{rec.DMS_id}"
        out_path = output_dir / f"{rec.DMS_id}.csv"
        if manifest.is_done(task) and out_path.exists() and not args.overwrite:
            log.emit("task_skipped", task=task)
            continue
        dms_path = Path(args.dms_dir) / (rec.DMS_filename or f"{rec.DMS_id}.csv")
        if not dms_path.exists():
            log.emit("task_missing_input", task=task, path=str(dms_path))
            continue
        try:  # per-assay isolation: one bad assay must not stop the others
            columns, rows = _read_csv(dms_path)
            if "mutated_sequence" not in columns and "mutant" in columns:
                columns.append("mutated_sequence")
                for row in rows:
                    row["mutated_sequence"] = apply_mutant(rec.target_seq, row["mutant"])
            key = "mutant" if "mutant" in columns else "mutated_sequence"
            checkpoint = args.checkpoint
            if args.checkpoint_root:
                eve_path = (rec.raw or {}).get("EVE_model_path")
                if not eve_path or eve_path in NA_STRINGS:
                    log.emit("task_missing_input", task=task,
                             path="EVE_model_path (reference column)")
                    continue
                checkpoint = str(Path(args.checkpoint_root) / eve_path)
            ctx = ScoreContext(
                record=rec,
                mutants=[row[key] for row in rows],
                device=device,
                mutated_sequences=[row["mutated_sequence"] for row in rows],
                msa_dir=Path(args.msa_dir) if args.msa_dir else None,
                weights_dir=Path(args.weights_dir) if args.weights_dir else None,
                checkpoint=checkpoint,
                structure_dir=Path(args.structure_dir) if args.structure_dir else None,
                indel_mode=args.indel_mode,
                batch_size=args.batch_size,
                extra=extra,
                assay=Table({c: [row[c] for row in rows] for c in columns}, n_rows=len(rows)),
            )
            with log.phase("score", task=task, n_mutants=len(rows)), \
                    throughput.measure(len(rows), label=task):
                scores = scorer(ctx)
            table = _score_table(columns, rows, scores)
            if writer:
                write_csv(out_path, table)
            manifest.mark_done(task, rows=len(table))
        except Exception as e:  # noqa: BLE001 — per-assay isolation
            failures += 1
            manifest.mark_failed(task, error=repr(e))
            log.emit("task_failed", task=task, error=repr(e))
            if args.fail_fast:
                raise
    return failures


def _cmd_score_packed(args, records, output_dir, log, manifest, device, extra, throughput,
                      profile_ctx) -> int:
    """Cross-assay packed scoring (``score --packed``, ESM masked marginals
    only): the masked rows of all pending assays share forward batches.
    Each output CSV holds the input columns plus the score column."""
    if args.model != "esm":
        print("--packed currently supports --model esm")
        return 2
    tasks = []  # (record, columns, rows)
    for rec in records:
        task = f"{args.model}/{rec.DMS_id}"
        out_path = output_dir / f"{rec.DMS_id}.csv"
        if manifest.is_done(task) and out_path.exists() and not args.overwrite:
            log.emit("task_skipped", task=task)
            continue
        dms_path = Path(args.dms_dir) / (rec.DMS_filename or f"{rec.DMS_id}.csv")
        if not dms_path.exists():
            log.emit("task_missing_input", task=task, path=str(dms_path))
            continue
        try:
            tasks.append((rec, *_read_csv(dms_path)))
        except Exception as e:  # noqa: BLE001 — per-assay input isolation
            manifest.mark_failed(task, error=repr(e))
            log.emit("task_failed", task=task, error=repr(e))
    if not tasks:
        return 0
    n_total = sum(len(rows) for _, _, rows in tasks)
    try:
        with profile_ctx, log.phase("score_packed", n_assays=len(tasks), n_mutants=n_total), \
                throughput.measure(n_total, label=f"packed/{len(tasks)}"):
            outputs = score_esm_packed_batch(
                [(rec, [row["mutant"] for row in rows]) for rec, _, rows in tasks],
                args.checkpoint, batch_size=args.batch_size, extra=extra, device=device,
            )
    except Exception as e:  # noqa: BLE001 — batch-level failure
        for rec, _, _ in tasks:
            manifest.mark_failed(f"{args.model}/{rec.DMS_id}", error=repr(e))
        log.emit("task_failed", task="packed_batch", error=repr(e))
        if args.fail_fast:
            raise
        return 1
    for rec, columns, rows in tasks:
        write_csv(output_dir / f"{rec.DMS_id}.csv",
                  _score_table(columns, rows, outputs[rec.DMS_id]))
        manifest.mark_done(f"{args.model}/{rec.DMS_id}", rows=len(rows))
    log.emit("throughput_summary", **throughput.summary())
    return 0


def cmd_weights(args) -> int:
    from proteingym_tpu_torch.msa.parser import load_msa
    from proteingym_tpu_torch.msa.weights import sequence_weights

    device = resolve_device(args.device)
    msa = load_msa(args.msa)
    w = sequence_weights(msa.matrix, theta=args.theta, device=device)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    np.save(args.output, w)
    print(f"N={len(w)} Neff={w.sum():.2f} -> {args.output}")
    return 0


def cmd_train(args) -> int:
    """Train an alignment model (EVE's VAE, or the Potts model by
    pseudolikelihood) on one assay's MSA and write it (the reference's
    training_EVE_models.sh role, ref train_VAE.py)."""
    import torch

    from proteingym_tpu_torch.models import eve, potts
    from proteingym_tpu_torch.pipeline.scorers import POTTS_ALPHABET

    device = resolve_device(args.device)
    reference = load_reference(args.dms_reference)
    rec = reference[args.dms_id] if args.dms_id else reference[args.dms_index or 0]
    ctx = ScoreContext(record=rec, mutants=[], device=device, msa_dir=Path(args.msa_dir),
                       weights_dir=Path(args.weights_dir) if args.weights_dir else None)
    msa = ctx.load_msa()
    stem = Path(args.output_dir) / f"{args.model}_{rec.DMS_id}_seed{args.seed}"
    stem.parent.mkdir(parents=True, exist_ok=True)
    if args.model == "eve":
        model = eve.train(msa.one_hot(), msa.weights, eve.EveConfig(seq_len=msa.seq_len),
                          steps=args.steps, seed=args.seed, device=device)
        torch.save(eve.checkpoint_dict(model), stem)
        print(f"EVE checkpoint -> {stem}")
    else:
        model = potts.train_potts_plm(msa.matrix, msa.weights, POTTS_ALPHABET,
                                      np.asarray(msa.focus_cols) + (rec.MSA_start or 1),
                                      msa.focus_seq_trimmed, steps=args.steps, device=device)
        potts.write_plmc_model(model, f"{stem}.model")
        print(f"Potts model -> {stem}.model")
    return 0


def cmd_merge(args) -> int:
    from proteingym_tpu_torch.merge.merge import filesystem_loaders, merge_all

    reference = load_reference(args.dms_reference)
    registry = _load_registry_arg(args.config, args.dataset, args.mutation_type)
    dms_loader, score_loader = filesystem_loaders(args.dms_dir, args.scores_root)
    merge_all(reference, registry, dms_loader, score_loader, args.output_dir,
              mutation_type=args.mutation_type)
    return 0


def cmd_evaluate(args) -> int:
    from proteingym_tpu_torch.metrics.aggregate import (
        directory_scores_loader, evaluate_benchmark,
    )

    device = resolve_device(args.device)
    reference = load_reference(args.dms_reference)
    registry = _load_registry_arg(args.config, args.dataset, args.mutation_type,
                                  constants_path=args.constants)
    timings = {}
    t0 = time.perf_counter()
    evaluate_benchmark(reference, registry, directory_scores_loader(args.merged_dir),
                       args.output_dir, indel_mode=args.mutation_type == "indels",
                       bootstrap_samples=args.bootstrap_samples,
                       write_html=not args.no_html, device=device, timings=timings)
    EventLog(Path(args.output_dir) / "events.jsonl").emit(
        "evaluate", device=str(device), n_assays=len(reference),
        seconds=round(time.perf_counter() - t0, 4),
        **{f"{k}_seconds": round(v, 4) for k, v in timings.items()})
    return 0


def cmd_evaluate_clinical(args) -> int:
    from proteingym_tpu_torch.metrics.aggregate import directory_scores_loader
    from proteingym_tpu_torch.metrics.clinical import evaluate_clinical

    device = resolve_device(args.device)
    reference = load_reference(args.clinical_reference)
    registry = _load_registry_arg(args.config, "clinical", args.mutation_type)
    evaluate_clinical(reference, registry, directory_scores_loader(args.merged_dir),
                      args.output_dir, mutation_type=args.mutation_type,
                      label_column=args.label_column,
                      bootstrap_samples=args.bootstrap_samples,
                      write_html=not args.no_html, device=device)
    return 0


def cmd_supervised_score(args) -> int:
    """A supervised baseline over the assays, its out-of-fold predictions in
    the ``<output-dir>/<cv_scheme>/<model>/<DMS_id>.csv`` layout that
    merge-supervised reads."""
    from proteingym_tpu_torch.merge.supervised import read_csv_inferred
    from proteingym_tpu_torch.models.supervised_baselines import (
        load_aug_scores, make_embedding_feature_fn, run_supervised_baseline,
    )

    device = resolve_device(args.device)
    reference = load_reference(args.dms_reference)
    records = [reference[args.dms_id]] if args.dms_id else list(reference)
    feature_fn, model = None, args.model
    if model.lower() in ("embeddings_ridge", "embeddings"):
        model = "embeddings_ridge"
        feature_fn = make_embedding_feature_fn(args.checkpoint, device=device)
    out_root = Path(args.output_dir)
    for rec in records:
        dms_path = Path(args.dms_dir) / (rec.DMS_filename or f"{rec.DMS_id}.csv")
        if not dms_path.exists():
            print(f"missing {dms_path}; skipping")
            continue
        assay = read_csv_inferred(dms_path)
        aux = None
        if args.aug_col:
            aux = assay.floats(args.aug_col)
        elif args.aug_scores_dir:
            spath = Path(args.aug_scores_dir) / f"{rec.DMS_id}.csv"
            if spath.exists():
                aux = load_aug_scores(assay["mutant"].tolist(), spath, args.aug_score_col)
            else:
                print(f"no zero-shot scores for {rec.DMS_id}; running unaugmented")
        with no_tf32():
            results = run_supervised_baseline(assay, rec.target_seq, model=model, lam=args.lam,
                                              feature_fn=feature_fn, aux=aux, device=device)
        for scheme, preds in results.items():
            d = out_root / scheme / args.model.lower()
            d.mkdir(parents=True, exist_ok=True)
            write_csv(d / f"{rec.DMS_id}.csv", preds)
    return 0


def cmd_merge_supervised(args) -> int:
    from proteingym_tpu_torch.merge.supervised import (
        merge_supervised, supervised_filesystem_loaders,
    )

    device = resolve_device(args.device)
    reference = load_reference(args.dms_reference)
    registry = _load_registry_arg(args.config, "DMS_supervised", args.mutation_type)
    dms_loader, score_loader = supervised_filesystem_loaders(args.dms_dir, args.scores_root)
    merge_supervised(reference, registry, dms_loader, score_loader, output_dir=args.output_dir,
                     mutation_type=args.mutation_type, device=device)
    return 0


def cmd_evaluate_supervised(args) -> int:
    import json

    from proteingym_tpu_torch.data.table import read_csv
    from proteingym_tpu_torch.metrics.supervised import evaluate_supervised

    reference = load_reference(args.dms_reference)
    long_scores = read_csv(args.input_scoring_file, numeric=("Spearman", "MSE"))
    kwargs = {}
    if args.constants:
        with open(args.constants) as f:
            constants = json.load(f)
        kwargs = dict(clean_names=constants.get("supervised_clean_names"),
                      model_types=constants.get("supervised_model_types"),
                      model_references=constants.get("supervised_model_references"),
                      model_details=constants.get("supervised_model_details"))
    evaluate_supervised(long_scores, reference, args.output_dir, mutation_type=args.mutation_type,
                        top_model=args.top_model, bootstrap_samples=args.bootstrap_samples,
                        write_html_files=not args.no_html, **kwargs)
    return 0


def cmd_download(args) -> int:
    from proteingym_tpu_torch.data.download import (
        RESOURCES, count_resources, download_resources,
    )

    if args.list_only:
        for name, filename, sha, _raw in RESOURCES:
            print(f"{name:45s} {filename:55s} sha256:{sha[:12]}…")
        return 0
    out = download_resources(names=args.resources or None, cache=args.cache,
                             remove_zip=not args.keep_zip, force=args.force)
    for name, desc in count_resources(out).items():
        print(f"{name}: {desc}")
    return 0


def cmd_models(args) -> int:
    for name in sorted(SCORERS):
        print(name)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pgym-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("score", help="score assays with one model")
    s.add_argument("--model", required=True)
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--checkpoint-root", default=None, metavar="DIR",
                   help="per-assay checkpoints: DIR/<EVE_model_path> of each reference row "
                        "(the clinical reference's column); rows without one are skipped")
    s.add_argument("--dms-reference", required=True)
    s.add_argument("--dms-dir", required=True)
    s.add_argument("--dms-id", default=None)
    s.add_argument("--dms-index", type=int, default=None)
    s.add_argument("--msa-dir", default=None)
    s.add_argument("--weights-dir", default=None)
    s.add_argument("--structure-dir", default=None,
                   help="PDB files named <UniProt_ID>.pdb or <DMS_id>.pdb (escott, rsalor)")
    s.add_argument("--output-dir", required=True)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (the JAX CLI's --platform)")
    s.add_argument("--packed", action="store_true",
                   help="cross-assay packed scoring: masked rows from all "
                        "selected assays share forward batches (ESM "
                        "masked-marginals; the production throughput path)")
    s.add_argument("--mesh", default=None, metavar="SPEC",
                   help="process mesh for sharded ESM scoring, e.g. 'data=4,model=2' "
                        "(tensor-parallel weights + data-parallel mutant chunks); run every "
                        "rank under torchrun, rank 0 writes the outputs")
    s.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="trace the scoring run with torch.profiler (CPU + CUDA) into DIR, "
                        "a Chrome trace that TensorBoard's profiler plugin reads")
    s.add_argument("--indel-mode", action="store_true",
                   help="indel assays: score whole mutated sequences (Tranception, "
                        "TranceptEVE and hmm)")
    s.add_argument("--overwrite", action="store_true")
    s.add_argument("--fail-fast", action="store_true")
    s.add_argument("--quiet", action="store_true")
    s.add_argument("--extra", nargs="*", metavar="KEY=VAL")
    s.set_defaults(fn=cmd_score)

    w = sub.add_parser("weights", help="precompute MSA sequence weights")
    w.add_argument("--msa", required=True)
    w.add_argument("--theta", type=float, default=0.2)
    w.add_argument("--output", required=True)
    w.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the cluster-count kernel, cpu its plain version")
    w.set_defaults(fn=cmd_weights)

    tr = sub.add_parser("train", help="train an alignment model (eve/potts)")
    tr.add_argument("--model", required=True, choices=["eve", "potts"])
    tr.add_argument("--dms-reference", required=True)
    tr.add_argument("--dms-id", default=None)
    tr.add_argument("--dms-index", type=int, default=None)
    tr.add_argument("--msa-dir", required=True)
    tr.add_argument("--weights-dir", default=None)
    tr.add_argument("--output-dir", required=True)
    tr.add_argument("--steps", type=int, default=400_000)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains")
    tr.set_defaults(fn=cmd_train)

    mutation_types = ["substitutions", "indels"]
    m = sub.add_parser("merge", help="merge per-model scores per assay (host only)")
    m.add_argument("--dms-reference", required=True)
    m.add_argument("--dms-dir", required=True)
    m.add_argument("--scores-root", required=True)
    m.add_argument("--config", default=None)
    m.add_argument("--output-dir", required=True)
    m.add_argument("--dataset", default="DMS")
    m.add_argument("--mutation-type", default="substitutions", choices=mutation_types)
    m.set_defaults(fn=cmd_merge)

    e = sub.add_parser("evaluate", help="metrics + leaderboards")
    e.add_argument("--dms-reference", required=True)
    e.add_argument("--merged-dir", required=True)
    e.add_argument("--config", default=None)
    e.add_argument("--constants", default=None)
    e.add_argument("--output-dir", required=True)
    e.add_argument("--dataset", default="DMS")
    e.add_argument("--mutation-type", default="substitutions", choices=mutation_types)
    e.add_argument("--bootstrap-samples", type=int, default=10000)
    e.add_argument("--no-html", action="store_true")
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the per-assay metrics run")
    e.set_defaults(fn=cmd_evaluate)

    ec = sub.add_parser("evaluate-clinical", help="clinical AUC leaderboard")
    ec.add_argument("--clinical-reference", required=True)
    ec.add_argument("--merged-dir", required=True)
    ec.add_argument("--config", default=None)
    ec.add_argument("--output-dir", required=True)
    ec.add_argument("--mutation-type", default="substitutions", choices=mutation_types)
    ec.add_argument("--label-column", default=None)
    ec.add_argument("--bootstrap-samples", type=int, default=10000)
    ec.add_argument("--no-html", action="store_true")
    ec.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the per-protein AUCs run")
    ec.set_defaults(fn=cmd_evaluate_clinical)

    ss = sub.add_parser("supervised-score", help="supervised baselines (per CV scheme)")
    ss.add_argument("--model", default="OHE_ridge",
                    help="OHE_ridge | embeddings_ridge | ProteinNPT")
    ss.add_argument("--dms-reference", required=True)
    ss.add_argument("--dms-dir", required=True)
    ss.add_argument("--dms-id", default=None)
    ss.add_argument("--output-dir", required=True)
    ss.add_argument("--lam", type=float, default=1.0)
    ss.add_argument("--checkpoint", default=None,
                    help="the ESM trunk of embeddings_ridge (an ESM checkpoint spec)")
    ss.add_argument("--aug-col", default=None,
                    help="a zero-shot column of the assay CSV, appended as an 'Augmented' "
                         "ridge feature")
    ss.add_argument("--aug-scores-dir", default=None,
                    help="per-assay zero-shot score CSVs (<DMS_id>.csv, joined on mutant)")
    ss.add_argument("--aug-score-col", default=None)
    ss.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ridges and ProteinNPT run")
    ss.set_defaults(fn=cmd_supervised_score)

    ms = sub.add_parser("merge-supervised", help="merge supervised CV scores")
    ms.add_argument("--dms-reference", required=True)
    ms.add_argument("--dms-dir", required=True)
    ms.add_argument("--scores-root", required=True)
    ms.add_argument("--config", default=None)
    ms.add_argument("--output-dir", required=True)
    ms.add_argument("--mutation-type", default="substitutions", choices=mutation_types)
    ms.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the per-assay Spearman runs")
    ms.set_defaults(fn=cmd_merge_supervised)

    es = sub.add_parser("evaluate-supervised",
                        help="supervised Spearman/MSE leaderboards (host only)")
    es.add_argument("--dms-reference", required=True)
    es.add_argument("--input-scoring-file", required=True, help="the long merged scores CSV")
    es.add_argument("--constants", default=None)
    es.add_argument("--output-dir", required=True)
    es.add_argument("--mutation-type", default="substitutions", choices=mutation_types)
    es.add_argument("--top-model", default=None)
    es.add_argument("--bootstrap-samples", type=int, default=10000)
    es.add_argument("--no-html", action="store_true")
    es.set_defaults(fn=cmd_evaluate_supervised)

    dl = sub.add_parser("download", help="fetch + SHA256-verify + unzip benchmark resources")
    dl.add_argument("--resources", nargs="*", default=None,
                    help="resource names (default: all)")
    dl.add_argument("--cache", default=None, help="extraction directory")
    dl.add_argument("--force", action="store_true")
    dl.add_argument("--keep-zip", action="store_true")
    dl.add_argument("--list", action="store_true", dest="list_only",
                    help="print the resource table and exit")
    dl.set_defaults(fn=cmd_download)

    lm = sub.add_parser("models", help="list the scorers")
    lm.set_defaults(fn=cmd_models)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
