"""Plain PyTorch pieces of the GNN references: sparse products, the max
with its winners, autograd functions of both, TF32 rounding, the layer
stack, cross-entropy and AdamW.  Each architecture is a file of its own
beside this one (``reference/<arch>.py``) that names its layer.

Written from the models' equations, not from the port: it imports torch
alone.  It takes the benchmark's raw CSR adjacency, features, labels,
initial weights and optimizer settings, and works out everything the
program derives from them (normalized adjacencies, transposes, the
aggregations, gradients and AdamW updates) again.

The max follows the port's documented semantics: over a row's stored
entries with a nonzero value, the IEEE maximum of ``a * x`` (NaN wins,
``+0`` above ``-0``); the winner is the lowest column whose product equals
it (``+0`` and ``-0`` equal); a row with no such entry gives ``y = 0``,
``idx = -1``, ``coeff = 0``, and so does a row whose maximum is NaN
(``idx = -1``) or ``-inf`` (``y = 0``, the winner kept).

``precision`` is ``"float64"`` (what the program is judged against),
``"float32"``, or ``"tf32"``: float32 with the dense products in TF32, the
precision below the configuration's (the control).  On a card TF32 is
the cuBLAS path (``allow_tf32``); on the CPU the products' operands are
rounded to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import List, NamedTuple, Sequence

import torch

PRECISIONS = ("float64", "float32", "tf32")
# elements of one edge block of the max: [edges, k] products and indices
_MAX_BLOCK = 1 << 24


class Csr(NamedTuple):
    indptr: torch.Tensor  # int64 [n_rows + 1]
    indices: torch.Tensor  # int64 [nnz]
    values: torch.Tensor  # float [nnz]
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indptr.numel() - 1

    def rows(self) -> torch.Tensor:
        """The row of every stored entry."""
        counts = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(torch.arange(self.n_rows, device=counts.device), counts)

    def sparse(self) -> torch.Tensor:
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.indptr, self.indices, self.values,
                                           size=(self.n_rows, self.n_cols),
                                           check_invariants=False)


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (expected one of {PRECISIONS})")
    return torch.float64 if precision == "float64" else torch.float32


def from_csr(indptr, indices, values, n_cols: int, precision: str) -> Csr:
    return Csr(indptr.to(torch.int64), indices.to(torch.int64),
               values.to(dtype_of(precision)), n_cols)


def transpose(a: Csr) -> Csr:
    """``Aᵀ`` by a stable sort of the entries on their column."""
    order = torch.argsort(a.indices, stable=True)
    rows = a.rows()[order]
    counts = torch.bincount(a.indices, minlength=a.n_cols)
    indptr = torch.zeros(a.n_cols + 1, dtype=torch.int64, device=counts.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return Csr(indptr, rows, a.values[order], a.n_rows)


def gcn_normalize(a: Csr) -> Csr:
    """``D^-1/2 (A + I) D^-1/2``: the diagonal replaced by 1, D the row sums,
    computed in float64 and stored in ``a``'s dtype."""
    n = a.n_rows
    rows = a.rows()
    off = rows != a.indices
    diag = torch.arange(n, device=rows.device)
    r = torch.cat([rows[off], diag])
    c = torch.cat([a.indices[off], diag])
    v = torch.cat([a.values[off].double(), torch.ones(n, dtype=torch.float64, device=rows.device)])
    order = torch.argsort(r * a.n_cols + c)
    r, c, v = r[order], c[order], v[order]
    d = torch.zeros(n, dtype=torch.float64, device=rows.device).index_add_(0, r, v)
    inv = torch.where(d > 0, d.rsqrt(), torch.zeros_like(d))
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return Csr(indptr, c, (v * inv[r] * inv[c]).to(a.values.dtype), a.n_cols)


def spmm_sum(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``."""
    return a.sparse() @ x


def spmm_mean(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over each row's stored-entry count (1 for an empty row)."""
    counts = (a.indptr[1:] - a.indptr[:-1]).clamp(min=1).to(x.dtype)
    return spmm_sum(a, x) / counts[:, None]


def spmm_max(a: Csr, x: torch.Tensor):
    """``(y, idx, coeff)`` of the max aggregation, each ``[n_rows, k]``, in
    blocks of rows whose products fit ``_MAX_BLOCK`` elements."""
    n, k = a.n_rows, x.shape[1]
    dev, dt = x.device, x.dtype
    y = torch.empty((n, k), dtype=dt, device=dev)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    coeff = torch.empty((n, k), dtype=dt, device=dev)
    indptr = a.indptr.cpu()
    per_block = max(1, _MAX_BLOCK // max(k, 1))
    r0 = 0
    while r0 < n:
        e0 = int(indptr[r0])
        r1 = int(torch.searchsorted(indptr, e0 + per_block, right=True)) - 1
        r1 = min(max(r1, r0 + 1), n)
        e1 = int(indptr[r1])
        sub = Csr(a.indptr[r0:r1 + 1] - e0, a.indices[e0:e1], a.values[e0:e1], a.n_cols)
        y[r0:r1], idx[r0:r1], coeff[r0:r1] = _max_block(sub, x)
        r0 = r1
    return y, idx, coeff


def _max_block(a: Csr, x: torch.Tensor):
    n, k = a.n_rows, x.shape[1]
    dev, dt = x.device, x.dtype
    neg = torch.tensor(float("-inf"), dtype=dt, device=dev)
    row_of = a.rows()
    rows = row_of[:, None].expand(-1, k)
    live = (a.values != 0)[:, None]
    prod = torch.where(live, a.values[:, None] * x[a.indices], neg)  # [E, k]
    nan = torch.isnan(prod)
    clean = torch.where(nan, neg, prod)

    def row_reduce(values, how, init):
        out = torch.full((n, k), init, dtype=values.dtype, device=dev)
        return out.scatter_reduce(0, rows, values, how, include_self=True)

    top = row_reduce(clean, "amax", float("-inf"))
    pos_zero = ((clean == 0) & ~torch.signbit(clean)).to(dt)
    any_pos_zero = row_reduce(pos_zero, "amax", 0.0) > 0
    top = torch.where(top == 0, torch.where(any_pos_zero, 0.0, -0.0).to(dt), top)
    any_nan = row_reduce(nan.to(dt), "amax", 0.0) > 0
    top = torch.where(any_nan, torch.full_like(top, float("nan")), top)
    big = torch.iinfo(torch.int64).max
    cols = a.indices[:, None].expand(-1, k)
    attain = live & (clean == top[row_of])
    first = row_reduce(torch.where(attain, cols, big), "amin", big)
    idx = torch.where(first == big, -1, first)
    hit = attain & (cols == idx[row_of])
    coeff = row_reduce(torch.where(hit, a.values[:, None].expand(-1, k), neg), "amax",
                       float("-inf"))
    coeff = torch.where(idx < 0, torch.zeros_like(coeff), coeff)
    y = torch.where(torch.isneginf(top), torch.zeros_like(top), top)
    return y, idx, coeff


def scatter_max_grad(g: torch.Tensor, idx: torch.Tensor, coeff: torch.Tensor,
                     n_cols: int) -> torch.Tensor:
    """The max's backward: ``x̄[idx[i, c], c] += coeff[i, c] * g[i, c]``."""
    k = g.shape[1]
    live = idx >= 0
    flat = (idx.clamp(min=0) * k + torch.arange(k, device=g.device)).reshape(-1)
    src = torch.where(live, coeff * g, torch.zeros_like(g)).reshape(-1)
    out = torch.zeros(n_cols * k, dtype=g.dtype, device=g.device)
    return out.index_add(0, flat, src).reshape(n_cols, k)


class Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return spmm_sum(a, x)

    @staticmethod
    def backward(ctx, g):
        return spmm_sum(ctx.a_t, g.contiguous()), None, None


class Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a):
        y, idx, coeff = spmm_max(a, x)
        ctx.save_for_backward(idx, coeff)
        ctx.n_cols = x.shape[0]
        return y

    @staticmethod
    def backward(ctx, g):
        idx, coeff = ctx.saved_tensors
        return scatter_max_grad(g, idx, coeff, ctx.n_cols), None


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest even;
    the gradient passes through unchanged."""
    bits = t.detach().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and a.device.type != "cuda":
        return _tf32_round(a) @ _tf32_round(b)
    return a @ b


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """TF32 on for the card's float32 products under ``"tf32"``, off
    otherwise; the previous setting is restored."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class Model:
    """One architecture's forward over one graph, in one precision.

    An architecture is a file ``reference/<arch>.py`` whose ``Model``
    subclasses this one: :meth:`prepare` works out the matrices it
    aggregates over from the raw adjacency, :meth:`layer` is one layer's
    pre-activation.  ``params`` are tuples per layer, in the field order
    the configuration's ``weight_fields`` counts.
    """

    def __init__(self, indptr, indices, values, n_cols: int, precision: str):
        self.precision = precision
        self.dtype = dtype_of(precision)
        self.prepare(from_csr(indptr, indices, values, n_cols, precision))

    def prepare(self, a: Csr) -> None:
        raise NotImplementedError

    def layer(self, p: Sequence[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _matmul(a, b, self.precision)

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(self.dtype)

    def forward(self, params: Sequence[Sequence[torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
        """The logits; the caller holds :func:`matmul_precision`."""
        h = x
        for i, p in enumerate(params):
            h = self.layer(p, h)
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """The forward of ``params`` (tuples per layer) over features ``x``,
        in the model's precision, without gradients."""
        params = [[self.cast(t) for t in layer] for layer in params]
        with torch.no_grad(), matmul_precision(self.precision, x.device):
            return self.forward(params, self.cast(x))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``softmax(logits)``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def learning_rate(cfg: dict, step: int) -> float:
    """Linear warm-up to ``lr_peak`` over ``warmup_steps``, then a cosine
    from the peak to 10 % of it over ``decay_steps``."""
    warm = step / max(cfg["warmup_steps"], 1)
    frac = min(max((step - cfg["warmup_steps"]) / max(cfg["decay_steps"], 1), 0.0), 1.0)
    return cfg["lr_peak"] * min(warm, 0.1 + 0.45 * (1.0 + math.cos(math.pi * frac)))


class TrainTrace(NamedTuple):
    losses: List[float]  # the loss each step computed, before its update
    first_grads: List[torch.Tensor]  # step 1's gradient before clipping, per leaf
    first_norm: float  # its global norm
    params: List[torch.Tensor]  # the leaves after the last step


def train(model: Model, params0, x, labels, adamw: dict, steps: int) -> TrainTrace:
    """``steps`` full-graph steps: cross-entropy over every node, gradients,
    then AdamW (global-norm clipping, bias-corrected moments, decoupled
    weight decay)."""
    leaves = [model.cast(t) for layer in params0 for t in layer]
    sizes = [len(layer) for layer in params0]
    x = model.cast(x)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps = adamw["b1"], adamw["b2"], adamw["eps"]
    losses, first, first_norm = [], None, None
    for step in range(1, steps + 1):
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        layers, i = [], 0
        for size in sizes:
            layers.append(leaves[i:i + size])
            i += size
        with matmul_precision(model.precision, x.device):
            loss = cross_entropy(model.forward(layers, x), labels)
            grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        if first is None:
            first, first_norm = [g.detach().clone() for g in grads], norm
        clip = min(1.0, adamw["grad_clip"] / max(norm, 1e-9))
        grads = [g * clip for g in grads]
        lr = learning_rate(adamw, step)
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        new = []
        for j, (p, g) in enumerate(zip(leaves, grads)):
            m[j] = b1 * m[j] + (1 - b1) * g
            v[j] = b2 * v[j] + (1 - b2) * g * g
            upd = (m[j] / bc1) / (torch.sqrt(v[j] / bc2) + eps)
            new.append((p.detach() * (1.0 - lr * adamw["weight_decay"]) - lr * upd).detach())
        leaves = new
    return TrainTrace(losses, first, first_norm, leaves)
