"""Pure-Python sentencepiece model reader + unigram codec.

A copy of the JAX package's ``tokenizer/sp_model.py``. The reference
links the C++ ``sentencepiece`` library
(``src/tokenizer/tokenizer_impl_sp.h:35-59``); the port does not depend
on that wheel, so this module implements the needed subset natively:

- a minimal protobuf wire-format parser for ``ModelProto`` (the
  ``tokenizer.model`` file format): the pieces table (piece / score /
  type), the TrainerSpec special ids (unk/bos/eos/pad) and the
  NormalizerSpec whitespace options;
- unigram Viterbi encoding over the piece vocabulary with byte-fallback
  (llama-family models carry ``<0xNN>`` BYTE pieces) and the standard
  whitespace escaping (U+2581) + dummy-prefix normalization;
- decoding with CONTROL-piece skipping, BYTE-piece reassembly and the
  dummy-prefix leading-space strip.

Scope: the normalization implemented is whitespace escaping only (no
precompiled NFKC charsmap) — exact for llama/llama2-style models on
already-normalized text, which is the reference's own usage.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

SP_SPACE = "▁"

# NMT pre-normalization (sentencepiece nmt_nfkc, documented rules):
# whitespace variants -> U+0020; C0/C1 controls, DEL, zero-width and
# BOM characters -> dropped.
_NMT_PRE_MAP = {}
for _c in "\t\n\r\x0b\x0c":
    _NMT_PRE_MAP[ord(_c)] = " "
for _cp in (list(range(0x00, 0x09)) + [0x0E, 0x0F]
            + list(range(0x10, 0x20)) + [0x7F]
            + list(range(0x80, 0xA0))
            + [0x200B, 0x200C, 0x200D, 0x200E, 0x200F, 0xFEFF]):
    _NMT_PRE_MAP[_cp] = None

# SentencePiece.Type enum (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6


# -- protobuf wire parsing ---------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a message's fields.

    value is int for varint, bytes for length-delimited, raw 4/8 bytes
    for fixed32/64."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 1:
            val = data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class SPModel:
    """Parsed ``tokenizer.model`` (ModelProto) + unigram codec."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                 pad_id: int = -1, add_dummy_prefix: bool = True,
                 escape_whitespaces: bool = True,
                 normalizer_name: str = "identity",
                 remove_extra_whitespaces: bool = False):
        self.pieces = pieces
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_dummy_prefix = add_dummy_prefix
        self.escape_whitespaces = escape_whitespaces
        self.normalizer_name = normalizer_name
        self.remove_extra_whitespaces = remove_extra_whitespaces

        self._piece_to_id: Dict[str, int] = {}
        self._byte_pieces: Dict[int, int] = {}  # byte value -> id
        self._max_piece_len = 1
        min_score = 0.0
        for i, (piece, score, typ) in enumerate(pieces):
            if typ == TYPE_BYTE:
                # "<0xNN>"
                try:
                    self._byte_pieces[int(piece[1:-1], 16)] = i
                except ValueError:
                    pass
                continue
            if typ in (TYPE_NORMAL, TYPE_USER_DEFINED):
                self._piece_to_id.setdefault(piece, i)
                self._max_piece_len = max(self._max_piece_len, len(piece))
                min_score = min(min_score, score)
        # sentencepiece uses min_score - 10 as the unknown-char penalty
        self._unk_score = min_score - 10.0

    # -- construction --------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "SPModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SPModel":
        pieces: List[Tuple[str, float, int]] = []
        unk_id, bos_id, eos_id, pad_id = 0, 1, 2, -1
        add_dummy_prefix = True
        escape_whitespaces = True
        normalizer_name = "identity"
        remove_extra_whitespaces = False
        saw_trainer_ids = False
        for field, wire, val in _iter_fields(data):
            if field == 1 and wire == 2:  # repeated SentencePiece
                piece, score, typ = "", 0.0, TYPE_NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8", errors="replace")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        typ = v2
                pieces.append((piece, score, typ))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if w2 != 0:
                        continue
                    if f2 == 40:
                        unk_id, saw_trainer_ids = v2, True
                    elif f2 == 41:
                        bos_id = _sint(v2)
                    elif f2 == 42:
                        eos_id = _sint(v2)
                    elif f2 == 43:
                        pad_id = _sint(v2)
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        normalizer_name = v2.decode("utf-8",
                                                    errors="replace")
                    elif f2 == 3 and w2 == 0:
                        add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and w2 == 0:
                        escape_whitespaces = bool(v2)
        if not saw_trainer_ids:
            # fall back to the conventional control pieces
            for i, (piece, _s, typ) in enumerate(pieces):
                if typ == TYPE_UNKNOWN:
                    unk_id = i
                elif piece == "<s>":
                    bos_id = i
                elif piece == "</s>":
                    eos_id = i
        return cls(pieces, unk_id, bos_id, eos_id, pad_id,
                   add_dummy_prefix, escape_whitespaces,
                   normalizer_name, remove_extra_whitespaces)

    # -- codec ---------------------------------------------------------------

    def get_piece_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    def _normalize(self, text: str) -> str:
        """NormalizerSpec semantics. ``identity`` (llama-family models)
        is exact. For specs named ``nfkc`` / ``nmt_nfkc`` (and their
        ``_cf`` casefold variants) the precompiled charsmap is
        approximated: Unicode NFKC via :mod:`unicodedata` (cross-checked
        against HF tokenizers' Rust NFKC in tests/test_sp_crossval.py)
        plus sentencepiece's documented NMT pre-rules (whitespace
        variants to U+0020, control and zero-width characters dropped).
        The handful of bespoke charsmap deviations sentencepiece's
        builder adds on top are NOT reproduced — exact parity for those
        requires the library itself (reference: tokenizer_impl_sp.h:35).
        """
        name = self.normalizer_name
        if "nfkc" in name:
            import unicodedata
            if name.startswith("nmt"):
                text = text.translate(_NMT_PRE_MAP)
            text = unicodedata.normalize("NFKC", text)
            if name.endswith("_cf"):
                text = text.casefold()
        if self.remove_extra_whitespaces:
            while "  " in text:
                text = text.replace("  ", " ")
            text = text.strip(" ")
        # sentencepiece prepends the dummy-prefix space UNCONDITIONALLY
        # (normalizer.cc): " x" normalizes to "▁▁x", not "▁x".
        # Cross-validated against HF tokenizers' llama-style pipeline
        # (Prepend("▁") + Replace(" ", "▁")) in tests/test_sp_crossval.py.
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", SP_SPACE)
        return text

    def encode(self, text: str) -> List[int]:
        """Unigram Viterbi segmentation (maximize summed piece scores),
        with byte-fallback for uncovered characters."""
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        p2i = self._piece_to_id
        maxlen = self._max_piece_len
        for i in range(n):
            bi = best[i]
            if bi == NEG:
                continue
            matched = False
            for ln in range(1, min(maxlen, n - i) + 1):
                piece = s[i:i + ln]
                pid = p2i.get(piece)
                if pid is None:
                    continue
                matched = True
                sc = bi + self.pieces[pid][1]
                if sc > best[i + ln]:
                    best[i + ln] = sc
                    back[i + ln] = (i, pid)
            if not matched or best[i + 1] == NEG:
                # single-char fallback lattice edge (unk penalty); real
                # byte-piece expansion happens at traceback
                sc = bi + self._unk_score
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, -1)
        # traceback
        out: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            if pid >= 0:
                out.append(pid)
            else:
                ch = s[prev:pos]
                ids = self._byte_fallback(ch)
                out.extend(reversed(ids))
            pos = prev
        out.reverse()
        return out

    def _byte_fallback(self, ch: str) -> List[int]:
        if self._byte_pieces:
            ids = []
            for b in ch.encode("utf-8"):
                ids.append(self._byte_pieces.get(b, self.unk_id))
            return ids
        return [self.unk_id]

    def decode(self, ids: Sequence[int]) -> str:
        """Concatenate piece surfaces: CONTROL/UNUSED skipped, BYTE
        pieces reassembled as raw bytes, U+2581 -> space, then strip the
        dummy-prefix leading space (sentencepiece Decode semantics — the
        single-token leading-space quirk the reference fixes up lives
        exactly here, ``tokenizer_impl_sp.h:53-59``)."""
        buf = bytearray()
        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            piece, _score, typ = self.pieces[i]
            if typ in (TYPE_CONTROL, TYPE_UNUSED):
                continue
            if typ == TYPE_BYTE:
                try:
                    buf.append(int(piece[1:-1], 16))
                except ValueError:
                    pass
                continue
            if typ == TYPE_UNKNOWN:
                buf.extend(piece.encode("utf-8"))
                continue
            buf.extend(piece.replace(SP_SPACE, " ").encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        if text.startswith(" "):
            text = text[1:]
        return text


def _sint(v: int) -> int:
    """TrainerSpec ids are int32; protobuf varints encode negatives as
    10-byte two's complement — map back."""
    return v - (1 << 64) if v >= (1 << 63) else v
