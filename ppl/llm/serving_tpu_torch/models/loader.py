"""Weight loading for the port: an HF safetensors checkpoint directory,
or random weights from a seed.

The port of the JAX package's ``models/loader.py``. The checkpoint is
read by :class:`SafetensorsDir`, a reader of the safetensors format of
its own (the ``safetensors`` package is not a dependency of the port):
an 8-byte little-endian header length, a JSON header (tensor name ->
dtype, shape and byte offsets, plus an optional ``__metadata__``), then
the raw little-endian bytes, mapped with ``numpy.memmap`` and never
read whole. The mapping to the port's fused layout is the JAX loader's:

    q/k/v (or Baichuan's W_pack rows [q | k | v]) -> wqkv [D, KVH, G+2, hd]
    InternLM's q/k/v/o biases                     -> bqkv [KVH, G+2, hd], bo
    gate/up                                       -> w_gate_up [D, 2, I]
    lm_head (or embedding.T when tied or absent)  -> lm_head [D, V]

Each layer is read, built on the device and, with a ``quant_method``,
quantized before the next is read (:func:`llama.build_params`), so one
float layer is alive at a time, on the host and on the device.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from . import llama

logger = logging.getLogger("ppl.llm.serving_tpu_torch.loader")

# safetensors dtype -> (torch dtype, bytes an element)
_ST_DTYPES = {"BF16": (torch.bfloat16, 2), "F16": (torch.float16, 2),
              "F32": (torch.float32, 4)}


class CheckpointError(ValueError):
    pass


class SafetensorsDir:
    """Every tensor of the ``*.safetensors`` files of a directory (a
    sharded checkpoint's shards included), indexed from their headers;
    :meth:`get` returns one as a CPU tensor over the file's mapping."""

    def __init__(self, model_dir: str):
        self.files = sorted(glob.glob(os.path.join(model_dir,
                                                   "*.safetensors")))
        if not self.files:
            raise FileNotFoundError(f"no safetensors files in {model_dir}")
        # name -> (file, dtype, shape, absolute byte offset, byte count)
        self._index: Dict[str, Tuple[str, str, Tuple[int, ...], int, int]] = {}
        for path in self.files:
            for name, entry in self._read_header(path).items():
                if name in self._index:
                    raise CheckpointError(
                        f"tensor {name} is in both {self._index[name][0]} "
                        f"and {path}")
                self._index[name] = (path,) + entry
        self._maps: Dict[str, np.memmap] = {}

    @staticmethod
    def _read_header(path: str):
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            raw = f.read(8)
            if len(raw) != 8:
                raise CheckpointError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", raw)
            if n > size - 8:
                raise CheckpointError(f"{path}: header length {n} past the "
                                      f"end of the file")
            header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = info["dtype"]
            if dtype not in _ST_DTYPES:
                raise CheckpointError(
                    f"{path}: tensor {name} has dtype {dtype}; only "
                    f"{', '.join(_ST_DTYPES)} are read")
            shape = tuple(int(x) for x in info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
            want = int(np.prod(shape, dtype=np.int64)) * _ST_DTYPES[dtype][1]
            if end - begin != want or base + end > size:
                raise CheckpointError(
                    f"{path}: tensor {name} {dtype}{list(shape)} has "
                    f"offsets [{begin}, {end}) ({end - begin} bytes, "
                    f"{want} wanted; file {size} bytes)")
            out[name] = (dtype, shape, base + begin, end - begin)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self._index)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` in its own dtype, on the CPU, over the
        file's copy-on-write mapping (nothing is written back)."""
        if name not in self._index:
            raise CheckpointError(f"tensor {name} is not in the checkpoint "
                                  f"({', '.join(self.files)})")
        path, dtype, shape, offset, nbytes = self._index[name]
        if path not in self._maps:
            self._maps[path] = np.memmap(path, dtype=np.uint8, mode="c")
        t = torch.from_numpy(self._maps[path][offset:offset + nbytes])
        tdtype, size = _ST_DTYPES[dtype]
        if offset % size:
            t = t.clone()            # a misaligned tensor: copy it
        return t.view(tdtype).reshape(shape)


def load_hf_safetensors(model_dir: str, cfg: ModelConfig, device="cpu",
                        quant_method: str = "none",
                        quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Load a HuggingFace llama-family safetensors checkpoint directory
    into the port's parameters on ``device`` in ``cfg.dtype``, each layer
    quantized with ``quant_method`` as soon as it is loaded (and the
    lm_head when ``quantize_lm_head``)."""
    st = SafetensorsDir(model_dir)
    dtype = llama.torch_dtype(cfg.dtype)
    d, hd = cfg.hidden_dim, cfg.head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    g = n_q // n_kv

    def get(name, transpose=False):
        t = st.get(name).to(device=device, dtype=dtype, copy=True)
        return t.T.contiguous() if transpose else t

    def make_layer(i):
        pre = f"model.layers.{i}"
        if f"{pre}.self_attn.W_pack.weight" in st:
            # Baichuan fused qkv: rows are [q | k | v] stacked
            wpack = get(f"{pre}.self_attn.W_pack.weight", transpose=True)
            wq = wpack[:, :n_q * hd].reshape(d, n_kv, g, hd)
            wk = wpack[:, n_q * hd:(n_q + n_kv) * hd].reshape(d, n_kv, 1, hd)
            wv = wpack[:, (n_q + n_kv) * hd:].reshape(d, n_kv, 1, hd)
        else:
            # [D, H*hd] -> [D, KVH, G, hd]: HF q head h = kv*G + g_idx uses
            # kv head h // G, so a plain reshape lands each GQA group
            # together
            wq = get(f"{pre}.self_attn.q_proj.weight",
                     transpose=True).reshape(d, n_kv, g, hd)
            wk = get(f"{pre}.self_attn.k_proj.weight",
                     transpose=True).reshape(d, n_kv, 1, hd)
            wv = get(f"{pre}.self_attn.v_proj.weight",
                     transpose=True).reshape(d, n_kv, 1, hd)
        layer = {
            "attn_norm": get(f"{pre}.input_layernorm.weight"),
            "ffn_norm": get(f"{pre}.post_attention_layernorm.weight"),
            "wqkv": torch.cat([wq, wk, wv], dim=2),
            "wo": get(f"{pre}.self_attn.o_proj.weight", transpose=True),
            "w_gate_up": torch.stack(
                [get(f"{pre}.mlp.gate_proj.weight", transpose=True),
                 get(f"{pre}.mlp.up_proj.weight", transpose=True)], dim=1),
            "w_down": get(f"{pre}.mlp.down_proj.weight", transpose=True),
        }
        del wq, wk, wv
        if cfg.attn_bias:
            # InternLM-7B qkv/o biases, repacked to the fused layout
            bq = get(f"{pre}.self_attn.q_proj.bias").reshape(n_kv, g, hd)
            bk = get(f"{pre}.self_attn.k_proj.bias").reshape(n_kv, 1, hd)
            bv = get(f"{pre}.self_attn.v_proj.bias").reshape(n_kv, 1, hd)
            layer["bqkv"] = torch.cat([bq, bk, bv], dim=1)
            layer["bo"] = get(f"{pre}.self_attn.o_proj.bias")
        return layer

    embed = get("model.embed_tokens.weight")

    def make_lm_head():
        if cfg.tie_word_embeddings or "lm_head.weight" not in st:
            return embed.T.contiguous()
        return get("lm_head.weight", transpose=True)

    params = llama.build_params(
        cfg, embed, make_layer, lambda: get("model.norm.weight"),
        make_lm_head, dtype=dtype, device=device, quantize=quant_method,
        quantize_lm_head=quantize_lm_head)
    logger.info("loaded %d tensors from %s (%d files)", len(st), model_dir,
                len(st.files))
    return params


def load_params(cfg: ModelConfig, model_format: str, model_dir: str,
                seed: int = 0, device="cuda", quant_method: str = "none",
                quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Dispatch on ``model_format``: "hf" loads the safetensors of
    ``model_dir``; "random" draws the weights on ``device`` from a
    ``torch.Generator`` seeded with ``seed``. Either way each layer is
    quantized with ``quant_method`` as soon as it is made (and the lm_head
    when ``quantize_lm_head``)."""
    if model_format == "hf":
        return load_hf_safetensors(model_dir, cfg, device=device,
                                   quant_method=quant_method,
                                   quantize_lm_head=quantize_lm_head)
    if model_format == "random":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return llama.init_params(cfg, gen, dtype=llama.torch_dtype(cfg.dtype),
                                 device=device, quantize=quant_method,
                                 quantize_lm_head=quantize_lm_head)
    raise ValueError(f"unknown model_format {model_format}")
