"""PyTorch/CUDA port of the quantized LLM serving engine.

A second package beside ``ppl.llm.serving_tpu`` (the JAX reference) with
the same module layout, so each module's counterpart has the same name.
It imports ``torch`` and never ``jax``, and nothing of the JAX package.
Every TPU kernel on the served path is a CUDA kernel written for Hopper
(``csrc/``), built at first use; each has its plain PyTorch version
beside it, which is what runs on the CPU.

    tools/          CLI: offline_inference, llm_server and its clients,
                    eval_ppl, eval_accuracy_delta, microbenches
    serving/        the gRPC frontend, metrics, data-parallel router
    generator.py    continuous-batching decode loop (shared host logic)
    engine.py       eager step dispatch, bucketing, device I/O
    models/         the LLaMA-family step and NLL forward; the HF
                    safetensors loader
    ops/            plain PyTorch ops; ops/kernels/ the CUDA wrappers
    csrc/           CUDA C++ sources (sm_90a)
    utils/          host-side data structures (allocators, caches)
    tokenizer/      HF/sentencepiece/byte tokenizers + model BOS policies
"""

__version__ = "0.1.0"
