"""Counter cell semantics: linear (classic CMS) and logarithmic (Morris).

PyTorch counterpart of `repro/core/counters.py`.  For log base b > 1 the
paper's VALUE collapses to the unbiased Morris estimator

  Value(c) = (b^c - 1) / (b - 1)

and `nfold` adds n events in one step: move n units in estimate space,
then stochastically round back to a counter state (for n == 1 exactly the
paper's increment with probability b^-c).

The float math is the reference's as XLA's CPU backend compiles it
(`core/xla_f32.py`): the jitted graph by default, the op-by-op graph where
the reference's call runs eagerly, so log cells and estimates equal the
JAX package's bit for bit on any device, and the CUDA kernels compute the
same graph (`kernels/csrc/xla_f32.cuh`).  Constants are float32 0-dim
tensors on the operand's device: torch turns a division by a Python
scalar on CUDA into a multiplication by its reciprocal, which rounds
differently.

Storage helpers: torch has only barebones support for uint16/uint32, so
tables and rings keep their unsigned dtype (the reference's storage
layout, byte for byte) but every op on them goes through a signed view of
the same bytes (`signed_view`), and plain arithmetic runs on int64 values
masked to the cell width (`to_i64` / `from_i64`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import xla_f32

_DTYPES = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}
_BITS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}
_NUMPY = {torch.uint8: np.uint8, torch.uint16: np.uint16,
          torch.uint32: np.uint32}
_TORCH = {np.dtype(n): t for t, n in _NUMPY.items()}

MASK32 = 0xFFFF_FFFF


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """The same bytes as a dtype every torch op supports (uint8 as is)."""
    s = _SIGNED.get(t.dtype)
    return t if s is None else t.view(s)


def to_i64(t: torch.Tensor) -> torch.Tensor:
    """Unsigned storage (uint8/16/32) -> int64 values in [0, 2^bits)."""
    if t.dtype == torch.int64:
        return t
    bits = _BITS[t.dtype]
    out = signed_view(t).to(torch.int64)
    return out if bits == 8 else out & ((1 << bits) - 1)


def from_i64(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> unsigned storage `dtype`."""
    bits = _BITS[dtype]
    if bits == 8:
        return x.to(torch.uint8)
    half = 1 << (bits - 1)
    signed = torch.where(x >= half, x - (1 << bits), x)
    return signed.to(_SIGNED[dtype]).view(dtype)


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zero-filled unsigned storage, made through its signed twin."""
    s = _SIGNED.get(dtype, dtype)
    return torch.zeros(shape, dtype=s, device=device).view(dtype)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of an unsigned storage dtype (uint8/16/32)."""
    return np.dtype(_NUMPY[dtype])


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of an unsigned numpy storage dtype (uint8/16/32)."""
    return _TORCH[np.dtype(dtype)]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of unsigned storage in its numpy dtype."""
    host = signed_view(t).detach().cpu().numpy()
    np_dtype = _NUMPY.get(t.dtype)
    return host if np_dtype is None else host.view(np_dtype)


_NP_SIGNED = {np.dtype(np.uint16): (np.int16, torch.uint16),
              np.dtype(np.uint32): (np.int32, torch.uint32)}


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Copy of a numpy array (uint16/uint32 kept unsigned) on `device`
    (one copy: host to device, or host to host)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writeable buffer
        a = a.copy()
    signed = _NP_SIGNED.get(a.dtype)
    if signed is None:
        return torch.from_numpy(a).to(device, copy=True)
    np_signed, tdt = signed
    return torch.from_numpy(a.view(np_signed)).to(device, copy=True).view(tdt)


_CONSTS: dict = {}
_XLA_TABLES: dict = {}  # (CounterSpec, "em" / "pm" / "ep", device)
_TABLE_MAX = 1 << 20
_STATE_FNS = {"em": xla_f32.morris_em, "ep": xla_f32.morris_ep,
              "pm": xla_f32.morris_pm}


def f32_const(x: float, device) -> torch.Tensor:
    """Cached float32 0-dim tensor holding float32(x) on `device`."""
    key = (float(np.float32(x)), str(torch.device(device)))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(key[0], dtype=torch.float32,
                                        device=device)
    return c


def f32(x: float) -> float:
    """float32 rounding of x, as a Python float (what JAX's
    `jnp.float32(x)` holds)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class CounterSpec:
    """Static description of one sketch cell.

    kind: "linear" (classic CMS cell) or "log" (Morris counter).
    base: log base b > 1 (ignored for linear).
    bits: cell width in bits (8, 16, or 32).
    """

    kind: str = "log"
    base: float = 1.00025
    bits: int = 16

    def __post_init__(self):
        if self.kind not in ("linear", "log"):
            raise ValueError(f"unknown counter kind {self.kind!r}")
        if self.kind == "log" and not self.base > 1.0:
            raise ValueError("log counter needs base > 1")
        if self.bits not in _DTYPES:
            raise ValueError(f"bits must be one of {sorted(_DTYPES)}")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.bits]

    @property
    def cells_per_lane(self) -> int:
        """How many cells fit in one packed uint32 storage lane."""
        return 32 // self.bits

    @property
    def max_state(self) -> int:
        return (1 << self.bits) - 1

    @property
    def max_value(self) -> float:
        """Largest representable estimate (saturation point)."""
        if self.kind == "linear":
            return float(self.max_state)
        return float(math.expm1(self.max_state * math.log(self.base))
                     / (self.base - 1.0))

    @property
    def logb(self) -> float:
        """float32(log b): the constant every log-space op multiplies by."""
        return f32(math.log(self.base))

    @property
    def bm1(self) -> float:
        """float32(b - 1): the decode denominator."""
        return f32(self.base - 1.0)

    @property
    def rbm1(self) -> float:
        """float32(1 / bm1) as XLA folds it: the jitted decode's factor."""
        return xla_f32.recip(self.bm1)

    # ---- estimate-space transforms (all float32, vectorized) ----
    #
    # Two graphs, as the reference computes them (`core/xla_f32.py`): the
    # JITTED form (`decode`, `encode_floor`, `nfold`), which is what every
    # reference path under `jax.jit` rounds to -- the kernels' interpret mode,
    # the XLA engines (`update_xla`, `update_many`, `update_rows`,
    # `update_score_rows`, the window reads), `lax.scan`'s `update_exact` and
    # the sharded functions under `shard_map` -- and which the CUDA kernels
    # compute; and the EAGER form (`decode_eager`, the re-encodes), what the
    # reference's op-by-op calls round to: `merge(estimate_sum)`, `decay`, the
    # decayed fold, and `core.sketch.query` / `update_batched` called outside
    # jit, vmapped or not (`eager=True` on `nfold`).  `point_mass` and
    # `increase_prob` are one exp each and the same in both.  Transcendentals
    # of integral states are gathers from per-device tables (`_states`); only
    # `log1p` of a value runs per element.

    def decode(self, state: torch.Tensor) -> torch.Tensor:
        """Counter state -> unbiased event-count estimate (paper's VALUE),
        jitted form: expm1(s * logb) * f32(1 / bm1).  Integral states."""
        s = state.to(torch.float32)
        if self.kind == "linear":
            return s
        return self._states(s, "em") * f32_const(self.rbm1, s.device)

    def decode_scaled(self, state: torch.Tensor, w: torch.Tensor
                      ) -> torch.Tensor:
        """decode(state) * w for a weight w that broadcasts as a scalar a
        row (the window reads' bucket weight), jitted form: XLA
        reassociates a log cell's (expm1(s logb) * f32(1 / bm1)) * w into
        expm1(s logb) * (w * f32(1 / bm1)).  Weights and products are
        flushed as XLA's CPU flushes denormals."""
        s = state.to(torch.float32)
        w = xla_f32.flush(w.to(torch.float32))
        if self.kind == "linear":
            return xla_f32.flush(s * w)
        scale = xla_f32.flush(w * f32_const(self.rbm1, w.device))
        return xla_f32.flush(self._states(s, "em") * scale)

    def decode_eager(self, state: torch.Tensor) -> torch.Tensor:
        """`decode` as the reference computes it op by op: expm1(s * logb)
        / bm1, a true division.  What `merge(estimate_sum)`, `decay` and
        the decayed fold decode with before `reencode_stochastic`."""
        s = state.to(torch.float32)
        if self.kind == "linear":
            return s
        return self._states(s, "em") / f32_const(self.bm1, s.device)

    def point_mass(self, state: torch.Tensor) -> torch.Tensor:
        """Value(c+1) - Value(c) = b^c: estimate mass of one state step."""
        s = state.to(torch.float32)
        if self.kind == "linear":
            return torch.ones_like(s)
        return self._states(s, "pm")

    def increase_prob(self, state: torch.Tensor) -> torch.Tensor:
        """P(IncreaseDecision(c)) = b^-c (paper Alg. 1); 1 for linear."""
        s = state.to(torch.float32)
        if self.kind == "linear":
            return torch.ones_like(s)
        return self._states(s, "ep")

    def encode_floor(self, value: torch.Tensor) -> torch.Tensor:
        """Largest state c with Value(c) <= value (float32 in, float32
        out), jitted form (`xla_f32.morris_encode_floor`)."""
        v = value.to(torch.float32)
        if self.kind == "linear":
            return torch.floor(v)
        return xla_f32.morris_encode_floor(v, self.logb, self.bm1, self._em)

    def _encode_floor_eager(self, v: torch.Tensor) -> torch.Tensor:
        """`encode_floor` op by op: floor(log1p(v * bm1) / logb), less one
        where decode_eager of it exceeds v + 1e-6 * max(v, 1)."""
        dev = v.device
        c = torch.floor(xla_f32.log1p(v * f32_const(self.bm1, dev))
                        / f32_const(self.logb, dev))
        # guard float roundoff: never let Value(c) exceed v by a full step
        too_high = self.decode_eager(c) > v + f32_const(
            1e-6, dev) * torch.clamp_min(v, 1.0)
        return torch.clamp_min(c - too_high.to(torch.float32), 0.0)

    def _em(self, s: torch.Tensor) -> torch.Tensor:
        return self._states(s, "em")

    def _ep(self, s: torch.Tensor) -> torch.Tensor:
        return self._states(s, "ep")

    def _states(self, s: torch.Tensor, which: str) -> torch.Tensor:
        """expm1(s logb) ("em"), exp(s logb) ("pm") or exp(-(s logb))
        ("ep") of integral float32 states s >= 0 in `xla_f32`'s math.
        Gathered from a table of every state up to where XLA's exp clamps
        its argument (88.8; past it no value changes), built once per
        device; computed where that table would pass 2^20 entries."""
        dev = s.device
        key = (self, which, str(dev))
        table = _XLA_TABLES.get(key)
        if table is None:
            size = math.ceil(88.8 / self.logb) + 2
            if size > _TABLE_MAX:
                return _STATE_FNS[which](s, self.logb)
            states = torch.arange(size, dtype=torch.float32, device=dev)
            table = _XLA_TABLES[key] = _STATE_FNS[which](states, self.logb)
        idx = s.clamp(0, table.numel() - 1)
        return table[idx.to(torch.int64)]

    def reencode_stochastic(self, value: torch.Tensor,
                            rng=None) -> torch.Tensor:
        """Estimate-space value -> counter state, unbiased when rng given.

        Floor state plus a Bernoulli bump with probability equal to the
        residual in units of the local point mass, so
        E[decode(reencode_stochastic(v))] == v (clipped at max_state).
        `rng` is a raw threefry key: one uniform a cell of `value`'s
        shape (`prng.uniform`, JAX's draw bit for bit).  With rng None the
        floor state is returned.  Returns float32 states (float32 rounds
        CMS32 states past 2^24, as the reference does).  Eager form: its
        callers run op by op in the reference.
        """
        from repro_torch.core import prng  # prng imports this module

        v = value.to(torch.float32)
        if self.kind == "linear":
            s = torch.floor(v)
        else:
            s = self._encode_floor_eager(v)
        if rng is not None:
            frac = (v - self.decode_eager(s)) / self.point_mass(s)
            u = prng.uniform(rng, tuple(s.shape), device=s.device)
            s = s + (u < frac).to(torch.float32)
        return torch.clamp(s, 0.0, float(self.max_state))

    def cells(self, states: torch.Tensor) -> torch.Tensor:
        """float32 states -> int64 cell values, saturating at max_state as
        the reference's cast to the cell dtype does (CMS32's clip bound
        rounds to 2^32 in float32)."""
        return torch.clamp_max(states.to(torch.int64), self.max_state)

    def nfold(self, state: torch.Tensor, n: torch.Tensor,
              uniform: torch.Tensor, eager: bool = False) -> torch.Tensor:
        """Add n >= 0 events to counter `state` in one step.

        Unbiased in estimate space; for n == 1 exactly the paper's
        probabilistic increment.  `uniform` ~ U[0,1) drives the stochastic
        rounding.  `state` holds int64 cell values (or the cell dtype);
        returns int64 new states, saturating at max_state.  A log counter
        runs the jitted graph (`xla_f32.morris_nfold`), or with `eager`
        the reference's op-by-op one.
        """
        n = n.to(torch.float32)
        if self.kind == "linear":
            # integer-space path (float32 rounds past 2^24): whole part
            # plus a stochastic bump on the fraction, room-clamped
            s_u = to_i64(state)
            n_int = torch.floor(n)
            frac = n - n_int
            bump = (uniform < frac).to(torch.int64)
            room = self.max_state - s_u
            add_f = torch.clamp_max(n_int, 2147483648.0)
            add_u = torch.minimum(add_f.to(torch.int64) + bump, room)
            return s_u + add_u
        s = to_i64(state).to(torch.float32)
        if not eager:
            return xla_f32.morris_nfold(s, n, uniform, self.logb, self.bm1,
                                        self.max_state, self._em,
                                        self._ep).to(torch.int64)
        n = xla_f32.flush(n)
        v2 = self.decode_eager(s) + n
        c2 = torch.maximum(self._encode_floor_eager(v2), s)  # monotone
        frac = (v2 - self.decode_eager(c2)) / self.point_mass(c2)
        inc = (uniform < frac).to(torch.float32)
        new = torch.where(n > 0, c2 + inc, s)
        new = torch.clamp(new, 0.0, float(self.max_state))
        return new.to(torch.int64)


def pack_table(table: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a (..., w) table of `bits`-wide cell states into uint32 lanes.

    Cell j of a row lands in lane j // cpl at bit offset (j % cpl) * bits
    (little-endian within the lane); returns torch.uint32 (..., w // cpl).
    """
    cpl = 32 // bits
    vals = to_i64(table)
    if cpl == 1:
        return from_i64(vals, torch.uint32)
    *lead, w = vals.shape
    if w % cpl:
        raise ValueError(f"width {w} not a multiple of cells_per_lane {cpl}")
    grouped = vals.reshape(*lead, w // cpl, cpl)
    out = torch.zeros((*lead, w // cpl), dtype=torch.int64,
                      device=vals.device)
    for s in range(cpl):
        out = out | (grouped[..., s] << (s * bits))
    return from_i64(out, torch.uint32)


def unpack_table(lanes: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of `pack_table`: (..., w/cpl) uint32 lanes -> (..., w)
    int64 states (each < 2**bits)."""
    cpl = 32 // bits
    vals = to_i64(lanes)
    if cpl == 1:
        return vals
    mask = (1 << bits) - 1
    parts = [(vals >> (s * bits)) & mask for s in range(cpl)]
    return torch.stack(parts, dim=-1).reshape(*vals.shape[:-1],
                                              vals.shape[-1] * cpl)


# The paper's three evaluated variants (§3.2), importable by name.
CMS32 = CounterSpec(kind="linear", base=1.0 + 1e-9, bits=32)
CMLS16 = CounterSpec(kind="log", base=1.00025, bits=16)
CMLS8 = CounterSpec(kind="log", base=1.08, bits=8)
