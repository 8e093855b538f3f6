"""Model-specific tokenizer wrappers + factory.

Mirrors the reference model wrappers and ``TokenizerFactory::Create``
(``src/tokenizer/tokenizer_factory.h:37-78``): llama/llama3/internlm
prepend BOS on encode (``models/llama/llama_tokenizer.h:35-38``), baichuan
does not (``models/baichuan/baichuan_tokenizer.h:35-37``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from .base import Tokenizer

# model_type -> prepend BOS on encode?
_BOS_POLICY = {
    "llama": True,
    "llama3": True,
    "internlm": True,
    "baichuan": False,
}


class ModelTokenizer(Tokenizer):
    """Applies a model family's BOS policy on top of a backend tokenizer."""

    def __init__(self, backend: Tokenizer, prepend_bos: bool):
        self._backend = backend
        self._prepend_bos = prepend_bos

    def encode(self, text: str) -> List[int]:
        ids = self._backend.encode(text)
        if self._prepend_bos:
            return [self._backend.bos_id] + ids
        return ids

    def decode(self, token_ids: Sequence[int]) -> str:
        return self._backend.decode(token_ids)

    @property
    def bos_id(self) -> int:
        return self._backend.bos_id

    @property
    def eos_id(self) -> int:
        return self._backend.eos_id

    @property
    def vocab_size(self) -> int:
        return self._backend.vocab_size


class ByteTokenizer(Tokenizer):
    """Byte-level tokenizer for benchmarks/tests with random weights
    (no tokenizer files required; throughput is tokenizer-independent)."""

    bos_id = 1
    eos_id = 2
    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, token_ids: Sequence[int]) -> str:
        return bytes(t for t in token_ids if 0 <= t < 256).decode(
            "utf-8", errors="replace")


def create_tokenizer(model_type: str, path: str,
                     tokenizer_type: Optional[str] = None,
                     config_path: Optional[str] = None) -> Tokenizer:
    """``TokenizerFactory::Create(model_type, tokenizer_type, path,
    config_path)`` equivalent.

    ``tokenizer_type``: "hf" | "sentencepiece" | "dummy" | None (auto by
    extension: .json -> hf, .model -> sentencepiece; a directory looks for
    tokenizer.json / tokenizer.model inside).
    """
    if tokenizer_type == "dummy":
        return ByteTokenizer()
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "tokenizer.json")):
            config_path = config_path or os.path.join(
                path, "tokenizer_config.json")
            path = os.path.join(path, "tokenizer.json")
        elif os.path.exists(os.path.join(path, "tokenizer.model")):
            path = os.path.join(path, "tokenizer.model")
        else:
            raise FileNotFoundError(f"no tokenizer found under {path}")
    if tokenizer_type is None:
        tokenizer_type = "hf" if path.endswith(".json") else "sentencepiece"

    if tokenizer_type == "hf":
        from .hf_tokenizer import HFTokenizer
        backend = HFTokenizer(path, config_path)
    elif tokenizer_type == "sentencepiece":
        from .sp_tokenizer import SPTokenizer
        backend = SPTokenizer(path)
    else:
        raise ValueError(f"unknown tokenizer_type {tokenizer_type}")

    prepend_bos = _BOS_POLICY.get(model_type, True)
    return ModelTokenizer(backend, prepend_bos)
