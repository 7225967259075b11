"""Orchestration: checkpoint specs, scorers and the CLI (counterpart of
proteingym_tpu.pipeline; manifest and telemetry are the port's own
copies, writing the same records)."""
