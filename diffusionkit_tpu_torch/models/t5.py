"""T5 encoder (T5-XXL for FLUX) as ``nn.Module``s, in plain torch.

Counterpart of ``diffusionkit_tpu/models/t5.py`` (which runs no Pallas
kernel): token embedding, pre-RMSNorm encoder layers and a final RMSNorm.
One relative-position bias is computed from the shared bucket table and
added to every layer's scores. T5 conventions kept: no 1/sqrt(d) scaling,
softmax in fp32, an fp32 residual stream with the matmul inputs cast to the
weight dtype, and the gated FFN ``wo(gelu_tanh(wi_0 x) * wi_1 x)`` (t5-v1_1's
NewGELU). A w8a8 T5 (``quantize_t5``, ``W8A8Linear``s) quantizes the normed
input once for q/k/v and once for wi_0/wi_1 (kernel D on the card), as the
reference does; ``out_proj`` and ``wo`` quantize their float inputs
themselves.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import T5Config
from ..ops.common import linear
from ..ops.norms import rms_norm
from ..ops.w8a8 import needs_act_quant, quantize_shared


def relative_position_bucket(
    relative_position: np.ndarray,
    bidirectional: bool = True,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> np.ndarray:
    """HF-compatible bucketing of key - query offsets (host numpy)."""
    relative_buckets = np.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        relative_buckets += (relative_position > 0).astype(np.int32) * num_buckets
        relative_position = np.abs(relative_position)
    else:
        relative_position = -np.minimum(relative_position, 0)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    scale = (num_buckets - max_exact) / np.log(max_distance / max_exact)
    rp_large = max_exact + (
        np.log(np.maximum(relative_position, 1).astype(np.float32) / max_exact) * scale
    ).astype(np.int32)
    rp_large = np.minimum(rp_large, num_buckets - 1)
    return relative_buckets + np.where(is_small, relative_position, rp_large)


class T5Layer(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype):
        super().__init__()
        d, inner, dff = config.d_model, config.d_kv * config.num_heads, config.d_ff
        self.config = config
        self.ln1 = nn.RMSNorm(d, eps=config.layer_norm_epsilon, dtype=dtype)
        self.ln2 = nn.RMSNorm(d, eps=config.layer_norm_epsilon, dtype=dtype)
        self.query_proj = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.key_proj = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.value_proj = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.out_proj = nn.Linear(inner, d, bias=False, dtype=dtype)
        self.wi_0 = nn.Linear(d, dff, bias=False, dtype=dtype)
        self.wi_1 = nn.Linear(d, dff, bias=False, dtype=dtype)
        self.wo = nn.Linear(dff, d, bias=False, dtype=dtype)

    def _attention(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        nh = self.config.num_heads
        xq = quantize_shared(x) if needs_act_quant(self.query_proj) else x

        def heads(layer):
            return linear(layer, xq).reshape(b, s, nh, -1).transpose(1, 2)

        q, k, v = heads(self.query_proj), heads(self.key_proj), heads(self.value_proj)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + bias[None]
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(x.dtype)
        return linear(self.out_proj, o.transpose(1, 2).reshape(b, s, -1))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x: (B, S, d_model) fp32 residual stream; bias (heads, S, S) fp32."""
        eps = self.config.layer_norm_epsilon
        wdtype = self.ln1.weight.dtype
        y = rms_norm(x, self.ln1.weight, eps).to(wdtype)
        x = x + self._attention(y, bias).float()
        y = rms_norm(x, self.ln2.weight, eps).to(wdtype)
        yq = quantize_shared(y) if needs_act_quant(self.wi_0) else y
        h = F.gelu(linear(self.wi_0, yq), approximate="tanh") * linear(self.wi_1, yq)
        return x + linear(self.wo, h).float()


class T5Encoder(nn.Module):
    """forward(token ids (B, S)) -> (B, S, d_model) in the weight dtype."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.d_model, dtype=dtype)
        self.relative_attention_bias = nn.Embedding(
            config.relative_attention_num_buckets, config.num_heads, dtype=dtype
        )
        self.layers = nn.ModuleList(T5Layer(config, dtype) for _ in range(config.num_layers))
        self.final_ln = nn.RMSNorm(config.d_model, eps=config.layer_norm_epsilon, dtype=dtype)

    def position_bias(self, seq_len: int) -> torch.Tensor:
        """(heads, S, S) fp32 additive bias, shared by every layer."""
        pos = np.arange(seq_len)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            bidirectional=True,
            num_buckets=self.config.relative_attention_num_buckets,
            max_distance=self.config.relative_attention_max_distance,
        )
        table = self.relative_attention_bias.weight
        idx = torch.from_numpy(buckets.astype(np.int64)).to(table.device)
        return table[idx].permute(2, 0, 1).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.wte.weight[tokens].float()
        bias = self.position_bias(tokens.shape[1])
        for layer in self.layers:
            x = layer(x, bias)
        x = rms_norm(x, self.final_ln.weight, self.config.layer_norm_epsilon)
        return x.to(self.wte.weight.dtype)


@torch.no_grad()
def init_t5(
    config: T5Config, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32, std: float = 0.02,
) -> T5Encoder:
    """Random T5 encoder on ``device``, as the reference's ``init_t5_params``:
    embeddings, the bucket table and every projection ~ N(0, std) from
    ``generator``, RMSNorm weights one."""
    with torch.device("meta"):
        model = T5Encoder(config, dtype)
    model.to_empty(device=device)
    for module in model.modules():
        if isinstance(module, nn.RMSNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, std, generator=generator)
    return model.eval()
