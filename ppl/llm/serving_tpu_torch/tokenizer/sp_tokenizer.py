"""sentencepiece backend (a copy of the JAX package's
``tokenizer/sp_tokenizer.py``).

Equivalent of the reference ``TokenizerImplSP``
(``src/tokenizer/tokenizer_impl_sp.h:35-59``), including the single-token
leading-space decode fix-up: sentencepiece drops the leading U+2581 space
marker when decoding a lone token, so a piece beginning with the marker
must re-gain a leading space (``tokenizer_impl_sp.h:53-59``).

Backend selection: the C++ ``sentencepiece`` wheel is used when
installed; otherwise the pure-Python reader/codec in
:mod:`.sp_model` loads the same ``tokenizer.model`` ModelProto files
(unigram Viterbi + byte-fallback) — no external dependency required.
"""

from __future__ import annotations

from typing import List, Sequence

from .base import Tokenizer

_SP_SPACE = "▁"


class SPTokenizer(Tokenizer):
    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
            self._sp = spm.SentencePieceProcessor(model_file=model_path)
        except ImportError:
            from .sp_model import SPModel
            self._sp = _PureProcessor(SPModel.load(model_path))

    def encode(self, text: str) -> List[int]:
        return list(self._sp.encode(text))

    def decode(self, token_ids: Sequence[int]) -> str:
        ids = list(token_ids)
        text = self._sp.decode(ids)
        if len(ids) == 1:
            # leading-space fix-up for streaming single-token decode
            piece = self._sp.id_to_piece(ids[0])
            if piece.startswith(_SP_SPACE):
                text = " " + text
        return text

    @property
    def bos_id(self) -> int:
        return self._sp.bos_id()

    @property
    def eos_id(self) -> int:
        return self._sp.eos_id()

    @property
    def vocab_size(self) -> int:
        return self._sp.get_piece_size()


class _PureProcessor:
    """Adapter giving :class:`.sp_model.SPModel` the small slice of the
    ``SentencePieceProcessor`` API this module touches."""

    def __init__(self, model):
        self._m = model

    def encode(self, text: str) -> List[int]:
        return self._m.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._m.decode(ids)

    def id_to_piece(self, i: int) -> str:
        return self._m.id_to_piece(i)

    def bos_id(self) -> int:
        return self._m.bos_id

    def eos_id(self) -> int:
        return self._m.eos_id

    def get_piece_size(self) -> int:
        return self._m.get_piece_size()
