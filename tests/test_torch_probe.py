"""The precision probe's plain version against the JAX probe, on the CPU.

``relp_tpu_torch/tools/probe_dot_precision.py`` ports
``scripts/probe_dot_precision.py``; its plain version
(``probe_dot_reference``) computes what the CUDA kernels compute:

* ``round_tf32`` is ``cvt.rna.tf32.f32`` bit for bit, held against an
  arithmetic reference in numpy (round |x| to 11 significant bits, ties
  away from zero, subnormals on the same 2^-136 grid) on ties, carries into
  the exponent, the largest finite values that do not overflow,
  subnormals and signed zeros;
* each plain version against the JAX probe's Pallas kernel in interpret
  mode (loaded by path, nothing in the JAX package edited), at M = 64 and
  256 on numpy inputs from a seed: ``outer`` bitwise equal to
  ``kernel_outer``, also at M = 1,920 and on edge values (signed zeros,
  subnormals, infinities, NaN by position: XLA's CPU multiply reads
  subnormal inputs as zero and flushes products tiny after rounding, and
  so does the plain version); ``tf32x3`` within 1e-6 * max|plain| of ``kernel_hi``;
  ``tf32`` within 1e-6 * max|plain| of ``kernel`` on inputs rounded to
  TF32 in numpy (on the CPU JAX's default-precision dot is full f32).
  The tolerance is f32 summation order over K <= 256 (the JAX kernels sum
  in f32, the plain version in f64) plus, for ``tf32x3``, the lo * lo
  term it drops;
* the TF32 rounding is really there: the plain ``tf32``'s error against
  the exact product is above 1e-5 at M=256;
* ``probe_dot`` raises on a wrong kind, dtype, shape, device mix,
  layout or M (a positive multiple of 64), and ``run`` on the CPU gives
  errors in the bands chip_smoke.py checks on the card.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from relp_tpu_torch.tools import probe_dot_precision as probe
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_dot_precision.py"


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location("jax_probe_dot_precision", _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cvt_rna_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 of finite f32 values by arithmetic in f64: |x| to a
    multiple of its quantum 2^(e - 10) (e its binary exponent, at least
    -126), ties away from zero."""
    x64 = np.asarray(x, np.float32).astype(np.float64)
    mag = np.abs(x64)
    _, e = np.frexp(np.where(mag > 0, mag, 1.0))
    quantum = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    rounded = np.floor(mag / quantum + 0.5) * quantum
    return (np.copysign(rounded, x64)).astype(np.float32)


_EDGE_BITS = {
    "plus_zero": [0x00000000],
    "minus_zero": [0x80000000],
    "exact_tf32": [0x3F800000, 0x3F802000, 0xC0A46000],
    "tie_up": [0x3F801000, 0x3F803000, 0x42C85000],
    "negative_tie": [0xBF801000, 0xBF803000, 0xC2C85000],
    "below_and_above_tie": [0x3F800FFF, 0x3F801001, 0xBF800FFF, 0xBF801001],
    "carry_into_exponent": [0x3FFFF000, 0xBFFFFFFF, 0x3F7FF000, 0x00FFF000],
    "largest_finite": [0x7F7FEFFF, 0x7F7FE000, 0xFF7FEFFF, 0x7F7FD001],
    "subnormal": [0x00000001, 0x00000FFF, 0x00001000, 0x00003000, 0x80001000,
                  0x007FFFFF, 0x807FF000, 0x00400000],
    "smallest_normal": [0x00800000, 0x80800FFF, 0x00801000],
}


@pytest.mark.parametrize("case", sorted(_EDGE_BITS))
def test_round_tf32_is_cvt_rna(case):
    bits = np.array(_EDGE_BITS[case], dtype=np.uint32)
    x = bits.view(np.float32)
    got = probe.round_tf32(torch.from_numpy(x.copy())).numpy()
    want = cvt_rna_reference(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(np.isfinite(got))
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)


def test_round_tf32_on_random_values():
    """Every rounding of a million random bit patterns (finite ones only)."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < np.float32(3.4e38))]
    got = probe.round_tf32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), cvt_rna_reference(x).view(np.uint32))


def _inputs(M, seed=11):
    rng = np.random.default_rng(seed + M)
    return (rng.standard_normal((M, M)).astype(np.float32),
            rng.standard_normal((M, M)).astype(np.float32))


def _pallas(fn, a, b):
    M = a.shape[0]
    out = pl.pallas_call(fn, out_shape=jax.ShapeDtypeStruct((M, M), jnp.float32),
                         interpret=True)(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(out)


@pytest.mark.parametrize("kind,M", [(kind, M) for kind in probe.KINDS for M in (64, 256)]
                         + [("outer", 1920)])
def test_plain_version_matches_jax_kernel(jax_probe, kind, M):
    a, b = _inputs(M)
    plain = probe.probe_dot_reference(kind, torch.from_numpy(a), torch.from_numpy(b))
    assert plain.dtype == torch.float64
    plain = plain.numpy()
    if kind == "outer":
        jax_out = _pallas(jax_probe.kernel_outer, a, b)
        np.testing.assert_array_equal(plain.astype(np.float32), jax_out)
        assert np.array_equal(plain, jax_out.astype(np.float64))  # exact in f32
        return
    if kind == "tf32":
        jax_out = _pallas(jax_probe.kernel, cvt_rna_reference(a), cvt_rna_reference(b))
    else:
        jax_out = _pallas(jax_probe.kernel_hi, a, b)
    scale = np.abs(plain).max()
    assert np.abs(jax_out.astype(np.float64) - plain).max() <= 1e-6 * scale


def test_outer_plain_matches_jax_kernel_on_edge_values(jax_probe):
    """Every pair of ``EDGE_BITS`` (signed zeros, subnormals, infinities,
    NaNs, products that underflow, overflow or fall beside the flush's
    threshold) multiplied by the plain version and by ``kernel_outer``:
    the same f32 bits, NaN in the same places."""
    a, b = probe.edge_inputs("cpu")
    plain = probe.probe_dot_reference("outer", a, b).to(torch.float32)
    jax_out = torch.from_numpy(_pallas(jax_probe.kernel_outer, a.numpy(), b.numpy()).copy())
    assert probe.same_bits(plain, jax_out) and bool(torch.isnan(jax_out).any())
    n = len(probe.EDGE_BITS)
    head = plain[:n, :n]
    assert bool((head == 0).any() & torch.isinf(head).any())
    assert not bool(((head != 0) & (head.abs() < probe.FLT_MIN)).any())  # nothing subnormal
    assert bool((head.view(torch.int32) == -2**31).any())  # a negative zero


@pytest.mark.parametrize("a_bits,b_bits,want", [
    (0x00000001, 0x7F7FFFFF, 0x00000000),  # a subnormal input reads as zero
    (0x80000001, 0x3F800000, 0x80000000),  # ... its sign kept
    (0x7F800000, 0x00000001, 0x7FC00000),  # inf times a subnormal is inf times zero
    (0x1F800000, 0xA0000000, 0x80000000),  # 2^-64 (-2^-63): a subnormal product flushed
    (0x00C00000, 0x3F2AAAAA, 0x00000000),  # 2^-126 - 2^-150: tiny after rounding
    (0x00800001, 0x3F7FFFFE, 0x00800000),  # 2^-126 - 2^-172 rounds up to 2^-126
    (0x5F800000, 0x5F800000, 0x7F800000),  # 2^64 2^64 overflows
    (0x00800000, 0x3F800000, 0x00800000),  # the smallest normal stays
])
def test_outer_reference_flushes_as_xla(a_bits, b_bits, want):
    """The plain outer product on single pairs, against the bits that
    XLA's CPU multiply gives (NaN by its being NaN)."""
    def f32(bits):
        return np.array([bits], np.uint32).view(np.float32)[0]

    a, b = np.zeros((64, 64), np.float32), np.zeros((64, 64), np.float32)
    a[0, 0], b[0, 0] = f32(a_bits), f32(b_bits)
    got = probe.outer_reference(torch.from_numpy(a), torch.from_numpy(b))[0, 0].numpy()
    if np.isnan(f32(want)):
        assert np.isnan(got)
    else:
        assert got.view(np.uint32) == want


def test_plain_tf32_rounds():
    a, b = _inputs(256)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = probe.exact_product("tf32", ta, tb)
    assert probe.relative_error(probe.probe_dot_reference("tf32", ta, tb), exact) > 1e-5
    assert probe.relative_error(probe.probe_dot_reference("tf32x3", ta, tb), exact) < 1e-6


def test_split_recovers_the_input():
    """hi + lo of the 3xTF32 split is x to within x's 22nd bit."""
    x = torch.from_numpy(_inputs(64)[0])
    hi, lo = probe._split(x)
    assert torch.equal(probe.round_tf32(hi), hi) and torch.equal(probe.round_tf32(lo), lo)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())


def test_probe_dot_on_cpu_is_the_plain_version_in_f32():
    a, b = map(torch.from_numpy, _inputs(64))
    for kind in probe.KINDS:
        out = probe.probe_dot(kind, a, b)
        assert out.dtype == torch.float32 and out.shape == (64, 64)
        assert torch.equal(out, probe.probe_dot_reference(kind, a, b).to(torch.float32))


_GOOD = torch.zeros((64, 64), dtype=torch.float32)


@pytest.mark.parametrize("kind,a,b,match", [
    ("tf64", _GOOD, _GOOD, "kind"),
    ("tf32", _GOOD.double(), _GOOD.double(), "float32"),
    ("tf32", _GOOD, _GOOD.double(), "float32"),
    ("tf32x3", _GOOD, torch.zeros((64, 128)), r"\(64, 64\)"),
    ("outer", torch.zeros((64, 128)), torch.zeros((64, 128)), r"\(64, 64\)"),
    ("tf32", _GOOD, torch.zeros((64, 64), device="meta"), "on cpu"),
    ("tf32", torch.zeros((64, 128))[:, ::2], _GOOD, "contiguous"),
    ("tf32", torch.zeros((48, 48)), torch.zeros((48, 48)), "multiple of 64"),
    ("tf32x3", torch.zeros((96, 96)), torch.zeros((96, 96)), "multiple of 64"),
    ("outer", torch.zeros((0, 0)), torch.zeros((0, 0)), "multiple of 64"),
])
def test_probe_dot_rejects_bad_arguments(kind, a, b, match):
    with pytest.raises(ValueError, match=match):
        probe.probe_dot(kind, a, b)


def test_same_bits_compares_nan_by_position():
    x = torch.tensor([1.0, -0.0, float("nan"), float("inf")])
    y = x.clone()
    y[2] = -float("nan")  # another NaN: the same by position
    assert probe.same_bits(x, y)
    assert not probe.same_bits(x, torch.tensor([1.0, 0.0, float("nan"), float("inf")]))
    assert not probe.same_bits(x, torch.tensor([1.0, -0.0, 1.0, float("inf")]))


def test_run_on_cpu_is_in_the_card_bands():
    """The bands chip_smoke.py holds the kernels to: single-pass TF32
    above 1e-6 and below 1e-2, 3xTF32 and the outer product at most
    1e-6.  No kernel runs, so no launch is counted."""
    before = dict(probe.LAUNCHES)
    err = probe.run(torch.device("cpu"))
    assert 1e-6 < err["tf32"] < 1e-2
    assert err["tf32x3"] <= 1e-6 and err["outer"] <= 1e-6
    assert probe.LAUNCHES == before
