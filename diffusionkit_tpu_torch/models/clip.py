"""CLIP text encoder (L/14 and bigG/14) as ``nn.Module``s.

Counterpart of ``diffusionkit_tpu/models/clip.py``: pre-LN layers in an
``nn.ModuleList``, the causal mask at a finite -6e4 in half precision,
pooling at the EOS position found by argmax over the token ids, every
layer's hidden state returned (SD3 reads the penultimate one), and the
optional ``text_projection``. The 77-token attention is a plain fp32
einsum, as in the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextModelConfig
from ..ops.common import linear
from ..ops.norms import layer_norm_affine


class CLIPOutput(NamedTuple):
    pooled_output: torch.Tensor
    last_hidden_state: torch.Tensor
    hidden_states: List[torch.Tensor]


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {"quick_gelu": _quick_gelu, "gelu": F.gelu}


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm_affine(x, ln.weight, ln.bias, eps=ln.eps)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextModelConfig, dtype: torch.dtype):
        super().__init__()
        d = config.model_dims
        self.config = config
        self.ln1 = nn.LayerNorm(d, eps=1e-5, dtype=dtype)
        self.ln2 = nn.LayerNorm(d, eps=1e-5, dtype=dtype)
        self.query_proj = nn.Linear(d, d, dtype=dtype)
        self.key_proj = nn.Linear(d, d, dtype=dtype)
        self.value_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)
        self.linear1 = nn.Linear(d, 4 * d, dtype=dtype)
        self.linear2 = nn.Linear(4 * d, d, dtype=dtype)

    def _attn(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        nh = self.config.num_heads
        d = c // nh

        def heads(layer):
            return linear(layer, x).reshape(b, s, nh, d).transpose(1, 2)

        q, k, v = heads(self.query_proj), heads(self.key_proj), heads(self.value_proj)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        scores = scores * (1.0 / d**0.5) + mask
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(x.dtype)
        return linear(self.out_proj, o.transpose(1, 2).reshape(b, s, c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.config.hidden_act]
        x = x + self._attn(_ln(self.ln1, x), mask)
        y = _ln(self.ln2, x)
        return x + linear(self.linear2, act(linear(self.linear1, y)))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = config.model_dims
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, d, dtype=dtype)
        self.position_embedding = nn.Embedding(config.max_length, d, dtype=dtype)
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(config, dtype) for _ in range(config.num_layers)
        )
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, dtype=dtype)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(d, config.projection_dim, bias=False, dtype=dtype)
        else:
            self.text_projection = None

    def forward(self, tokens: torch.Tensor) -> CLIPOutput:
        """Forward over integer token ids (B, N)."""
        b, n = tokens.shape
        eos_positions = torch.argmax(tokens, dim=-1)
        x = self.token_embedding.weight[tokens] + self.position_embedding.weight[:n]

        # Causal mask, finite in half precision.
        neg = -6e4 if x.dtype in (torch.float16, torch.bfloat16) else -1e9
        mask = torch.full((n, n), neg, dtype=torch.float32, device=tokens.device).triu(1)

        hidden_states = []
        for layer in self.layers:
            x = layer(x, mask)
            hidden_states.append(x)

        x = _ln(self.final_layer_norm, x)
        pooled = x[torch.arange(b, device=tokens.device), eos_positions]
        if self.text_projection is not None:
            pooled = linear(self.text_projection, pooled)
        return CLIPOutput(pooled, x, hidden_states)


@torch.no_grad()
def init_clip(
    config: CLIPTextModelConfig, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32, std: float = 0.02,
) -> CLIPTextModel:
    """Random CLIP text encoder on ``device``: embeddings and projections
    ~ N(0, std) from ``generator``, biases zero, LayerNorms identity."""
    with torch.device("meta"):
        model = CLIPTextModel(config, dtype)
    model.to_empty(device=device)
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, std, generator=generator)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
    return model.eval()
