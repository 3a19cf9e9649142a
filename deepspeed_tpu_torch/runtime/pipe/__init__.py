"""The pipeline engine (port of ``deepspeed_tpu/runtime/pipe/``)."""
