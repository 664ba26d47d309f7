"""``olmoasr.transcribe`` on the port: the long-form entry points and the
command line of ``olmoasr_tpu_torch.transcribe``."""

from olmoasr_tpu_torch.transcribe import cli, transcribe, transcribe_many

__all__ = ["cli", "transcribe", "transcribe_many"]
