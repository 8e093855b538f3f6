"""The port's sentencepiece tokenizer (``tokenizer/sp_model.py``,
``sp_tokenizer.py``) against the JAX package's on the same ModelProto
bytes: the hand-written proto of tests/test_sp_tokenizer.py and the
protobuf-runtime proto of tests/test_sp_crossval.py (the vocabulary
HF ``tokenizers``' Unigram is held to there), and chip_smoke's
32,000-piece proto. Ids, decodes, byte fallback and the single-token
leading-space fix-up are equal exactly; ``create_tokenizer`` resolves a
directory holding only ``tokenizer.model`` to it."""

import random

import pytest

from ppl.llm.serving_tpu.tokenizer.sp_model import SPModel as JSPModel
from ppl.llm.serving_tpu.tokenizer.sp_tokenizer import (
    SPTokenizer as JSPTokenizer)
from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
from ppl.llm.serving_tpu_torch.tokenizer.sp_model import SPModel
from ppl.llm.serving_tpu_torch.tokenizer.sp_tokenizer import SPTokenizer

import chip_smoke
import test_sp_crossval as crossval
from test_sp_tokenizer import VOCAB, build_model_bytes

TEXTS = crossval._corpus() + ["hello world", "hello Zé", "world hello hello",
                              "", "  ", "\U0001f680\U0001f600 bytes"]


def random_texts(n=60, seed=99):
    rng = random.Random(seed)
    alphabet = "abcdefghij XYZé你好.,!-\n\t0123456789\U0001f600"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
            for _ in range(n)]


PROTOS = {
    "hand_written": lambda: build_model_bytes(VOCAB),
    "hand_written_trainer_ids": lambda: build_model_bytes(
        VOCAB, trainer_ids=(0, 1, 2)),
    "protobuf_runtime": lambda: crossval._google_model_bytes(crossval.PIECES),
}


@pytest.fixture(scope="module", params=list(PROTOS))
def models(request):
    data = PROTOS[request.param]()
    return SPModel.from_bytes(data), JSPModel.from_bytes(data)


def test_parse_matches_jax(models):
    m, jm = models
    assert m.get_piece_size() == jm.get_piece_size()
    assert m.pieces == jm.pieces
    assert ((m.unk_id, m.bos_id, m.eos_id, m.pad_id)
            == (jm.unk_id, jm.bos_id, jm.eos_id, jm.pad_id))
    assert ((m.add_dummy_prefix, m.escape_whitespaces, m.normalizer_name)
            == (jm.add_dummy_prefix, jm.escape_whitespaces,
                jm.normalizer_name))


@pytest.mark.parametrize("which", ["corpus", "random"])
def test_encode_decode_match_jax(models, which):
    m, jm = models
    for text in (TEXTS if which == "corpus" else random_texts()):
        ids = m.encode(text)
        assert ids == jm.encode(text), repr(text)
        assert m.decode(ids) == jm.decode(ids), repr(text)


def test_byte_fallback_matches_jax(models):
    m, jm = models
    text = "\U0001f680 Zé"
    ids = m.encode(text)
    assert ids == jm.encode(text)
    assert any(m.pieces[i][2] == 6 for i in ids)     # a BYTE piece
    assert m.decode(ids) == text


@pytest.mark.parametrize("proto", ["hand_written", "protobuf_runtime"])
def test_tokenizer_single_token_decode_matches_jax(tmp_path, proto):
    """Every id decoded alone (the streaming detokenizer's call) equals
    the JAX tokenizer's, the leading-space fix-up included."""
    path = tmp_path / "tokenizer.model"
    path.write_bytes(PROTOS[proto]())
    tok, jtok = SPTokenizer(str(path)), JSPTokenizer(str(path))
    assert (tok.bos_id, tok.eos_id, tok.vocab_size) == (
        jtok.bos_id, jtok.eos_id, jtok.vocab_size)
    for i in range(tok.vocab_size):
        assert tok.decode([i]) == jtok.decode([i]), i
    spaced = [i for i in range(tok.vocab_size)
              if tok._sp.id_to_piece(i).startswith("▁")
              and len(tok._sp.id_to_piece(i)) > 1]
    assert spaced and all(tok.decode([i]).startswith(" ") for i in spaced)
    for text in TEXTS[:20]:
        assert tok.encode(text) == jtok.encode(text)


def test_chip_smoke_proto_matches_jax():
    """chip_smoke's ModelProto writer: its 32,000 pieces parse back as
    written, and both readers encode the repository's text alike."""
    pieces = chip_smoke.sp_pieces(chip_smoke.__file__.rsplit("/", 1)[0],
                                  32000)
    data = chip_smoke.sp_model_bytes(pieces)
    m, jm = SPModel.from_bytes(data), JSPModel.from_bytes(data)
    assert m.get_piece_size() == 32000
    assert [(p, t) for p, _, t in m.pieces] == [(p, t) for p, _, t in pieces]
    assert len({s for _, s, t in pieces if t == 1}) == 32000 - 259
    assert (m.unk_id, m.bos_id, m.eos_id, m.pad_id) == (0, 1, 2, -1)
    for text in TEXTS[:30]:
        ids = m.encode(text)
        assert ids == jm.encode(text)
        assert m.decode(ids) == jm.decode(ids)


@pytest.mark.parametrize("model_type,bos", [("llama", True),
                                            ("baichuan", False)])
def test_create_tokenizer_resolves_tokenizer_model(tmp_path, model_type,
                                                   bos):
    (tmp_path / "tokenizer.model").write_bytes(build_model_bytes(VOCAB))
    tok = create_tokenizer(model_type, str(tmp_path))
    assert isinstance(tok._backend, SPTokenizer)
    ids = tok.encode("hello world")
    assert (ids[0] == tok.bos_id) == bos
    jtok = JSPTokenizer(str(tmp_path / "tokenizer.model"))
    assert ids[int(bos):] == jtok.encode("hello world")
    assert tok.decode(ids) == "hello world"
