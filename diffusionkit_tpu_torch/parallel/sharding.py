"""Megatron tensor parallelism for the MMDiT and the T5: the shard plan.

Counterpart of ``diffusionkit_tpu/parallel/sharding.py``, whose path rules
are kept unchanged: a linear whose attribute name is a fan-out parent
(``COL_PARENTS``: q/k/v, fc1, the T5's query/key/value projections and
gated inputs, and ``ada``) is column-parallel over the mesh's ``model``
axis, its weight-like leaves (``KERNEL_LIKE``) and its bias and ``wscale``
split along the output; a fan-in parent (``ROW_PARENTS``: o, fc2,
out_proj, wo) is row-parallel, its weight-like leaves split along the
input, its bias and ``wscale`` whole. Everything else is replicated.
The rules name parents only, so they apply wherever such a name appears:
the embedders' ``fc1`` / ``fc2`` and the final layer's ``ada`` are split
too, as the reference splits them.

The reference's leaves map onto the port's layouts: ``nn.Linear.weight``
and ``W8A8Linear.w8`` are (out, in), ``QuantizedLinear.q4`` (in/8, out),
``q8`` (in, out), ``scales`` and ``zeros`` (groups, out). A leaf whose
target dim the axis does not divide stays whole (the reference's rule).
GSPMD can then mix layouts within one linear; the port cannot, so a
fan-in linear whose leaves do not all divide (a single quant group, say)
stays whole on every rank and gathers its input first: the plan lists it
as ``"gathered"``, decided here and never at call time.

``plan`` (also ``mmdit_plan`` / ``t5_plan``) gives, per linear, its layout (``"col"``,
``"row"``, ``"gathered"``, ``"whole"``) and, per parameter, the dim the
rule shards, the dim the port shards and its local shape;
``shard_module_`` keeps this rank's slices and marks each split linear
with its ``TensorParallel`` role, which ``ops/common.linear`` reads. A
model that comes from a file or the cache is sharded from host tensors,
so a rank never holds the whole model on its card. ``replicate`` puts a
model whole on the device (CLIP, the VAE). ``routes`` lists where each
split linear of a full-width model lands, kernel or not, by the rules
``ops/common.linear`` dispatches on (``ROADMAP.md`` records the
exceptions).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.quantized import QuantizedLinear
from ..ops.w8a8 import W8A8Linear
from .mesh import axis_index, axis_size, group

COL_PARENTS = frozenset({"q", "k", "v", "fc1", "query_proj", "key_proj", "value_proj",
                         "wi_0", "wi_1", "ada"})
ROW_PARENTS = frozenset({"o", "fc2", "out_proj", "wo"})
# The reference's leaf names; the port's float weight is its "kernel".
KERNEL_LIKE = frozenset({"kernel", "q4", "q8", "scales", "zeros", "w8"})
LINEARS = (nn.Linear, QuantizedLinear, W8A8Linear)

# The dim of each leaf that carries the output (fan-out) and the input
# (fan-in) of its linear, in the port's layout; None: not split that way.
_OUT_DIM = {"weight": 0, "w8": 0, "q4": 1, "q8": 1, "scales": 1, "zeros": 1,
            "bias": 0, "wscale": 0}
_IN_DIM = {"weight": 1, "w8": 1, "q4": 0, "q8": 0, "scales": 0, "zeros": 0}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A split linear's role on this rank: ``kind`` "col" (it returns its
    local columns) or "row" (its input is this rank's slice of the
    features; the partial products are summed over ``group``) or
    "gathered" (whole on every rank, its sharded input gathered first);
    ``n`` ranks, this one ``index``."""

    kind: str
    group: object
    n: int
    index: int


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """One parameter or buffer: ``rule_dim`` the dim the reference's rule
    shards in the port's layout (None: replicated), ``dim`` the dim the
    port shards (None: whole on every rank), the whole and local shapes."""

    name: str
    rule_dim: Optional[int]
    dim: Optional[int]
    shape: Tuple[int, ...]
    local: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """One linear: its layout ("col", "row", "gathered" or "whole"), the
    whole (in, out) and this rank's."""

    name: str
    layout: str
    features: Tuple[int, int]
    local: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Plan:
    n: int
    linears: Dict[str, LinearPlan]
    params: Dict[str, ParamPlan]

    def gathered(self) -> List[str]:
        """The fan-in linears kept whole, their input gathered."""
        return [k for k, v in self.linears.items() if v.layout == "gathered"]


def _leaf_rule(parent: Optional[str], leaf: str, shape, n: int) -> Optional[int]:
    """The reference's ``_spec_for`` on a port leaf: the dim it shards, or
    None where it replicates (a name off the rules, or a dim that ``n``
    does not divide)."""
    kernel_like = leaf == "weight" or leaf in KERNEL_LIKE
    if parent in COL_PARENTS and (kernel_like or leaf in ("bias", "wscale")):
        dim = _OUT_DIM.get(leaf)
    elif parent in ROW_PARENTS and kernel_like:
        dim = _IN_DIM.get(leaf)
    else:
        return None
    if dim is None or shape[dim] % n:
        return None
    return dim


def _layer_leaves(layer: nn.Module):
    """(name, tensor) of a linear's own parameters and buffers."""
    leaves = list(layer.named_parameters(recurse=False)) + list(layer.named_buffers(recurse=False))
    return [(k, t) for k, t in leaves if t is not None]


def plan(model: nn.Module, n: int) -> Plan:
    """The shard plan of ``model`` over ``n`` model ranks (module
    docstring); works on a model built on the ``meta`` device."""
    linears: Dict[str, LinearPlan] = {}
    params: Dict[str, ParamPlan] = {}
    for path, module in model.named_modules():
        if not isinstance(module, LINEARS):
            continue
        parent = path.rsplit(".", 1)[-1]
        leaves = _layer_leaves(module)
        rules = {k: _leaf_rule(parent, k, tuple(t.shape), n) for k, t in leaves}
        split = [k for k, t in leaves if k != "bias" and k != "wscale"]
        if n == 1 or parent not in COL_PARENTS | ROW_PARENTS:
            layout = "whole"
        elif parent in COL_PARENTS:
            layout = "col" if all(rules[k] is not None for k, _ in leaves) else "whole"
        elif module.in_features % n:
            layout = "whole"  # its producer is whole too
        else:
            layout = "row" if all(rules[k] is not None for k in split) else "gathered"
        k_in, k_out = module.in_features, module.out_features
        local = {"col": (k_in, k_out // n), "row": (k_in // n, k_out)}.get(layout, (k_in, k_out))
        linears[path] = LinearPlan(path, layout, (k_in, k_out), local)
        for k, t in leaves:
            dim = rules[k] if layout in ("col", "row") else None
            shape = tuple(t.shape)
            loc = list(shape)
            if dim is not None:
                loc[dim] //= n
            params[f"{path}.{k}"] = ParamPlan(f"{path}.{k}", rules[k], dim, shape, tuple(loc))
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name not in params and t is not None:
            params[name] = ParamPlan(name, None, None, tuple(t.shape), tuple(t.shape))
    return Plan(n, linears, params)


# The reference's mmdit_shardings / t5_shardings: one set of rules covers both.
mmdit_plan = t5_plan = plan


def _local(t: torch.Tensor, dim: Optional[int], n: int, index: int, device) -> torch.Tensor:
    """This rank's slice of t along ``dim`` (whole for None), contiguous on
    ``device``: sliced where t lies, so a host tensor moves only its slice,
    and copied, so the whole tensor's memory is freed with it."""
    if dim is None:
        return t.to(device)
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).to(device, copy=True).contiguous()


@torch.no_grad()
def shard_module_(model: nn.Module, mesh, device=None) -> nn.Module:
    """Keep this rank's slices of ``model`` by its plan over the mesh's
    ``model`` axis, in place, on ``device`` (default: where the model
    is), and mark every split linear with its ``TensorParallel``; the
    replicated parameters move to ``device`` whole. A model on the host
    moves only its slices. On a model axis of one rank nothing is split and
    no linear is marked: the model runs as it does with no mesh. Returns
    ``model``."""
    n = axis_size(mesh, "model")
    if device is None:
        device = next(model.parameters()).device
    if n == 1:
        return model.to(device)
    return _keep_slices_(model, plan(model, n), axis_index(mesh, "model"), group(mesh, "model"),
                         device)


def _keep_slices_(model: nn.Module, p: Plan, index: int, grp, device) -> nn.Module:
    """``shard_module_``'s work for rank ``index`` of ``p.n`` over ``grp``."""
    for path, module in model.named_modules():
        lin = p.linears.get(path)
        for k, t in _layer_leaves(module) if lin is not None else ():
            local = _local(t, p.params[f"{path}.{k}"].dim, p.n, index, device)
            if k in module._parameters:
                module._parameters[k] = nn.Parameter(local, requires_grad=False)
            else:
                module._buffers[k] = local
        if lin is None or lin.layout == "whole":
            continue
        module.in_features, module.out_features = lin.local
        module.tp = TensorParallel(lin.layout, grp, p.n, index)
    return model.to(device)


# A model whole on every rank (CLIP, the VAE): ``replicate(model, device)``.
replicate = nn.Module.to


def routes(model: nn.Module, n: int) -> Dict[str, Tuple[str, Tuple[int, int], str]]:
    """(layout, local (in, out), route) of every split linear of ``model``
    over ``n`` model ranks: the route is what ``ops/common.linear_route``
    gives rank 0's layer of a copy sharded on ``meta``, with ", FFN
    unfused" where ``ops/common.ffn_route`` does not fuse a w4a8 FFN
    (its local fc1 width not a multiple of E's 512-column scale tile) and
    ", heads gathered" where q/k/v do not hold whole heads on a rank
    (``Projections.holds_heads``). Meant for a model on ``meta``."""
    from ..ops.common import ffn_route, linear_route

    p = plan(model, n)
    local = _keep_slices_(copy.deepcopy(model).to("meta"), p, 0, None, "meta")
    head_dim = getattr(getattr(model, "config", None), "head_dim", None)
    out = {}
    for path, lin in p.linears.items():
        if lin.layout == "whole":
            continue
        owner_path, parent = path.rsplit(".", 1) if "." in path else ("", path)
        owner = local.get_submodule(owner_path)
        route = linear_route(owner.get_submodule(parent))
        if parent in ("fc1", "fc2") and route == "E" and ffn_route(owner.fc1, owner.fc2) != "fused":
            route += ", FFN unfused"
        if parent in ("q", "k", "v") and hasattr(owner, "holds_heads") \
                and not owner.holds_heads(head_dim):
            route += ", heads gathered"
        out[path] = (lin.layout, lin.local, route)
    return out


def off_kernel(model: nn.Module, n: int) -> List[str]:
    """The split linears of ``model`` over ``n`` ranks that leave their
    kernel or their layout (``routes``), named by their attribute (every
    block and stream alike): "name: layout, route"."""
    seen = []
    for path, (layout, _, route) in routes(model, n).items():
        entry = f"{path.rsplit('.', 1)[-1]}: {layout}, {route}"
        off = layout == "gathered" or "dequant_linear" in route or "," in route
        if off and entry not in seen:
            seen.append(entry)
    return seen
