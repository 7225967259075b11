"""Orchestration: checkpoint specs, scorers and the CLI (counterpart of
proteingym_tpu.pipeline; manifest and telemetry are shared with it)."""
