"""Examples of the port used as a library, run with ``python -m
ppl.llm.serving_tpu_torch.samples.<name>``."""
