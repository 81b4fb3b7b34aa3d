"""Feedforward (non-iterative) burst timing recovery via the MSK tone pair.

A vectorized alternative to the reference's sequential D'Andrea PLL
(lib/msk_timing_recovery_cc_impl.cc:138-202; our faithful port is
`sync/timing.py`).  Squaring an MSK/GMSK signal produces two spectral
tones at +-Rs/2 (the same physics the reference's freqest exploits,
lib/freqest_impl.cc:72-85).  The *phases* of those tones encode the
symbol clock: for a delay tau, each tone at f+- picks up -2*pi*f*tau, so

    psi = arg( C+ * conj(C-) ) = psi0 - 2*pi*tau/T

where C+- are correlations of x^2 against e^{-+j*pi*n/sps}.  Two dot
products per segment therefore give the symbol phase to sub-sample
accuracy, a weighted linear fit across segments tracks clock-rate
offset, and symbol extraction becomes one batched 8-tap interpolation —
no sequential state at all.  A common frequency offset shifts both tones
equally and cancels in the product, so the estimator is unbiased under
residual AFC error.

The mapping from tone phase to absolute symbol-center position is fixed
by a one-time numpy calibration against this package's own modulator
(`_calibrate`), which also measures the optimum sampling point the same
way an eye diagram would.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ais_tpu.ops.interp import DELAY, NSTEPS, NTAPS, interp_taps


def _tone_psi(x: np.ndarray, sps: float) -> float:
    n = np.arange(x.size)
    theta = np.pi / sps
    z = x.astype(np.complex128) ** 2
    cp = np.sum(z * np.exp(-1j * theta * n))
    cm = np.sum(z * np.exp(+1j * theta * n))
    return float(np.angle(cp * np.conj(cm)))


@functools.lru_cache(maxsize=8)
def _calibrate(sps_int: int, bt: float) -> float:
    """Return `delta` such that symbol centers sit at positions
    p = delta - psi * sps / (2*pi)  (mod sps) for a measured tone phase
    psi.  Calibrated on clean modulated data from ais_tpu.tx.gmsk."""
    from ais_tpu.tx.gmsk import modulate_bits

    rng = np.random.default_rng(12345)
    bits = rng.integers(0, 2, 600)
    x = np.asarray(modulate_bits(bits, sps_int, bt)).astype(np.complex128)
    # Eye-open search: the sampling offset maximizing the mean |phase
    # step| between consecutive symbol-spaced samples.
    bank = interp_taps()
    best_q, best_m = 0.0, -1.0
    for qi in range(int(sps_int * 20)):
        q = qi / 20.0
        pos = np.arange(100 + q, x.size - 20, sps_int)
        i0 = np.floor(pos).astype(int)
        mu = pos - i0
        rows = bank[np.round(mu * NSTEPS).astype(int)]
        frames = x[(i0 - DELAY)[:, None] + np.arange(NTAPS)[None, :]]
        ys = (frames * rows).sum(axis=1)
        m = np.abs(np.angle(ys[1:] * np.conj(ys[:-1]))).mean()
        if m > best_m:
            best_m, best_q = m, q
    psi = _tone_psi(x[100:-100], sps_int)
    # centers at best_q (mod sps) when tone phase is psi:
    # best_q = delta - psi*sps/(2*pi)  ->  delta = best_q + psi*sps/(2*pi)
    return float(np.mod(best_q + psi * sps_int / (2 * np.pi), sps_int))


def refine_freq(
    burst: jax.Array,
    sps: float,
    seg_len: int = 256,
    min_weight_frac: float = 0.25,
) -> jax.Array:
    """Fine residual-carrier estimate (Hz * 2pi/fs, i.e. rad/sample).

    The +Rs/2 tone of x^2 sits at theta + 2*w0 (theta = pi/sps known);
    its phase advances (theta + 2*w0)*seg_len per segment, so the wrapped
    segment-to-segment phase slope of C+ yields w0 with ~Hz accuracy —
    enough to make a packet-length coherent demod possible (the AFC's
    binsize/2 quantization alone leaves ~10 rad of drift over a packet).
    Unambiguous for |w0| < pi/(2*seg_len) (~±46 Hz at 48 ksps, seg 256).
    """
    length = burst.shape[-1]
    n_segs = length // seg_len
    theta = np.pi / sps
    n = np.arange(length)
    from ais_tpu.ops.cplx import const_complex

    tone_p = const_complex(np.exp(-1j * theta * n).astype(np.complex64))
    z = burst * burst
    zp = (z * tone_p)[: n_segs * seg_len].reshape(n_segs, seg_len)
    cp = jnp.sum(zp, axis=-1)
    w = jnp.abs(cp)
    prod = cp[1:] * jnp.conj(cp[:-1])
    ww = jnp.sqrt(w[1:] * w[:-1])
    ww = jnp.where(ww >= min_weight_frac * jnp.max(ww), ww, 0.0)
    # arg(prod) = 2*w0*seg_len (theta*seg_len contribution is exact and
    # cancels in the conjugate product since the tone reference removes
    # theta already).
    slope = jnp.angle(jnp.sum(prod * (ww / jnp.maximum(jnp.sum(ww), 1e-12))))
    return (slope / (2.0 * seg_len)).astype(jnp.float32)


def estimate_timing(
    burst: jax.Array,
    sps: float,
    bt: float = 0.4,
    seg_len: int = 256,
    min_weight_frac: float = 0.25,
):
    """Tone-phase timing estimate: (base, intercept, slope).

    Symbol centers sit at p_k = base + k*sps + intercept + slope*(...)
    (see feedforward_symbols for the exact grid construction).
    """
    length = burst.shape[-1]
    n_segs = length // seg_len
    sps_int = int(round(sps))
    delta = _calibrate(sps_int, bt)
    theta = np.pi / sps

    n = np.arange(length)
    from ais_tpu.ops.cplx import const_complex

    tone_p = const_complex(np.exp(-1j * theta * n).astype(np.complex64))
    tone_m = const_complex(np.exp(+1j * theta * n).astype(np.complex64))

    z = burst * burst
    zp = (z * tone_p)[: n_segs * seg_len].reshape(n_segs, seg_len)
    zm = (z * tone_m)[: n_segs * seg_len].reshape(n_segs, seg_len)
    cp = jnp.sum(zp, axis=-1)
    cm = jnp.sum(zm, axis=-1)
    prod = cp * jnp.conj(cm)
    psi = jnp.angle(prod)
    w = jnp.sqrt(jnp.abs(prod))
    w = jnp.where(w >= min_weight_frac * jnp.max(w), w, 0.0)

    tau = delta - psi * (sps / (2.0 * np.pi))
    conf = w > 0

    def _ffill(carry, xs):
        t, ok = xs
        new = jnp.where(ok, t, carry)
        return new, new

    tau_f = jax.lax.scan(_ffill, tau[0], (tau, conf))[1]
    first_idx = jnp.argmax(conf)
    tau0 = tau_f[first_idx]
    d = tau_f[1:] - tau_f[:-1]
    d = d - sps * jnp.round(d / sps)
    un = jnp.concatenate([jnp.zeros(1, tau.dtype), jnp.cumsum(d)])
    dtau = un - un[first_idx]
    centers = (jnp.arange(n_segs) + 0.5) * seg_len
    wsum = jnp.sum(w) + 1e-12
    cbar = jnp.sum(w * centers) / wsum
    tbar = jnp.sum(w * dtau) / wsum
    cov = jnp.sum(w * (centers - cbar) * (dtau - tbar))
    var = jnp.sum(w * (centers - cbar) ** 2) + 1e-12
    slope = cov / var
    intercept = tbar - slope * cbar
    base = tau0 + jnp.ceil((DELAY + 1.0 - tau0) / sps) * sps
    return base, intercept, slope


def feedforward_symbols(
    burst: jax.Array,
    sps: float,
    n_symbols: int,
    bt: float = 0.4,
    seg_len: int = 256,
    min_weight_frac: float = 0.25,
):
    """Recover `n_symbols` symbol-rate samples from one burst window.

    Returns (symbols complex64 (n_symbols,), valid bool (n_symbols,)).
    Drop-in replacement for the PLL's outputs (same downstream demod).
    """
    length = burst.shape[-1]
    base, intercept, slope = estimate_timing(
        burst, sps, bt=bt, seg_len=seg_len, min_weight_frac=min_weight_frac
    )
    # Symbol-center positions: nominal grid anchored at base, corrected by
    # the drift line.
    k = jnp.arange(n_symbols, dtype=jnp.float32)
    pos = base + k * sps
    pos = pos + intercept + slope * pos
    i0 = jnp.floor(pos).astype(jnp.int32)
    mu = pos - i0
    valid = (i0 - DELAY >= 0) & (i0 - DELAY + NTAPS <= length)
    i0c = jnp.clip(i0 - DELAY, 0, length - NTAPS)

    bank = jnp.asarray(interp_taps())
    rows = bank[jnp.clip(jnp.round(mu * NSTEPS).astype(jnp.int32), 0, NSTEPS)]
    frames = burst[i0c[:, None] + jnp.arange(NTAPS)[None, :]]
    symbols = jnp.sum(frames * rows, axis=-1)
    return symbols.astype(jnp.complex64), valid
