"""Batched FIR filtering / frequency-translating channelizer.

Tensor equivalent of upstream `filter.freq_xlating_fir_filter_ccf`
(reference: python/radio.py:51-54): mix the wideband stream down by the
channel offset, low-pass filter, and decimate — but over `(batch, time)`
tensor blocks instead of a sample stream.  Decimating filters run in
polyphase form (an einsum contraction or summed per-phase FFT products,
chosen per platform by `ais_tpu.core.backend`); the mixer carrier is
computed on the host (numpy float64 phase accumulation, so no float32
phase drift over long blocks) and rotated per-block by a scalar.

Convention: `y[n] = sum_k taps[k] * x[n*decim + k]` over VALID samples
only — callers supply `taps.size - 1` halo samples.  Taps are applied
un-reversed; the designs used here are symmetric so this matches the
reference's dot-product direction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def fir_filter(x: jax.Array, taps: np.ndarray, decim: int = 1) -> jax.Array:
    """Strided VALID FIR of complex input with real taps.

    x: (..., n) complex64;  returns (..., (n - ntaps)//decim + 1).

    Dispatch: decimating filters run in polyphase form (`_fir_polyphase`);
    non-decimating ones as a whole-block FFT product.  `_fir_filter_conv`
    is the plain `conv_general_dilated` reference the tests compare with.
    """
    if decim > 1:
        return _fir_polyphase(x, taps, decim)
    return _fir_fft(x, taps)


# Longest whole-block FFT `_fir_fft` takes; longer inputs are filtered
# overlap-save in segments of _MAX_FFT // 4 output samples.
_MAX_FFT = 1 << 18


def _fir_fft(x: jax.Array, taps: np.ndarray) -> jax.Array:
    """VALID FIR via zero-padded FFT products (overlap-save when long)."""
    n = x.shape[-1]
    t = np.asarray(taps, dtype=np.float32)
    ntaps = t.size
    nfft = 1 << (n - 1).bit_length()
    if nfft > _MAX_FFT:
        return _fir_fft_overlap_save(x, t)
    # Correlation orientation (y[j] = sum_k taps[k] x[j+k], matching the
    # polyphase/conv paths): convolve with time-reversed taps and take the
    # fully-overlapped span.
    tf = np.fft.fft(t[::-1], nfft).astype(np.complex64)
    from ais_tpu.ops.cplx import const_complex

    y = jnp.fft.ifft(jnp.fft.fft(x, nfft, axis=-1) * const_complex(tf), axis=-1)
    from ais_tpu.ops.framing import slice_last

    return slice_last(y, ntaps - 1, n).astype(jnp.complex64)


def _fir_fft_overlap_save(x: jax.Array, t: np.ndarray) -> jax.Array:
    """Overlap-save FFT filtering with bounded per-segment FFTs.

    Splits the output range into cores of `seg` samples; each segment
    filters its core plus a (ntaps-1)-sample halo with the direct FFT
    path.  Gather-free framing via ops.framing.frame_overlap.
    """
    from ais_tpu.ops.framing import frame_overlap

    ntaps = int(t.size)
    n = x.shape[-1]
    n_out = n - ntaps + 1
    seg = _MAX_FFT // 4
    if ntaps - 1 > seg:
        raise ValueError(f"taps {ntaps} too long for segment {seg}")
    nb = -(-n_out // seg)
    # Frame (nb + 1) cores so every block's halo reads real samples; the
    # extra block is dropped after filtering.
    need = (nb + 1) * seg
    if need > n:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (need - n,), x.dtype)], axis=-1
        )
    blocks = frame_overlap(x[..., :need], seg, ntaps - 1)[..., :nb, :]
    y = _fir_fft(blocks, t)                  # (..., nb, seg)
    y = y.reshape(*x.shape[:-1], nb * seg)
    return y[..., :n_out]


def _ifft_batch_safe(Y: jax.Array) -> jax.Array:
    """IFFT along the last axis; a flattened batch of fewer than 8 rows
    is padded with zero rows to 8 before the transform and cut back
    after it."""
    lead = Y.shape[:-1]
    n = Y.shape[-1]
    flat = Y.reshape(-1, n)
    b = flat.shape[0]
    if b >= 8:
        return jnp.fft.ifft(Y, axis=-1)
    padded = jnp.concatenate(
        [flat, jnp.zeros((8 - b, n), flat.dtype)], axis=0
    )
    return jnp.fft.ifft(padded, axis=-1)[:b].reshape(*lead, n)


def _csum_products(F: jax.Array, hf: jax.Array) -> jax.Array:
    """sum_p F[..., p, :] * hf[p, :], accumulated as four real products
    and two real sums over the phase axis."""
    fr, fi = F.real, F.imag
    hr, hi = hf.real, hf.imag
    yr = jnp.sum(fr * hr - fi * hi, axis=-2)
    yi = jnp.sum(fr * hi + fi * hr, axis=-2)
    return jax.lax.complex(yr, yi)


def polyphase_spectra(taps: np.ndarray, decim: int, n_out_hint: int) -> np.ndarray:
    """Host-precomputed per-phase reversed-tap spectra for `_fir_polyphase`.

    Returns (decim, nfft) complex64, passed as the `hf` argument (a
    device buffer) instead of being baked into the program as a constant.
    """
    t = np.asarray(taps, dtype=np.float32)
    ntaps = int(t.size)
    p_rows = -(-ntaps // decim)
    h = np.zeros((p_rows, decim), dtype=np.float32)
    h.flat[:ntaps] = t
    n_rows = n_out_hint + p_rows - 1
    nfft = 1 << (n_rows + p_rows - 2).bit_length()
    return np.fft.fft(h[::-1, :].T, nfft, axis=-1).astype(np.complex64)


def _fir_polyphase_einsum(x: jax.Array, taps: np.ndarray, decim: int) -> jax.Array:
    """Polyphase decimating FIR as one (rows, D) @ (D, P) contraction plus
    a P-term diagonal reduction (the "einsum" channelizer formulation).

    With k = p*D + r:  y[m] = sum_p Z[m+p, p],  Z = X @ H^T, where
    X[j, r] = x[j*D + r] (a reshape) and H[p, r] the padded tap matrix.
    """
    t = np.asarray(taps, dtype=np.float32)
    ntaps = int(t.size)
    n = x.shape[-1]
    n_out = (n - ntaps) // decim + 1
    p_rows = -(-ntaps // decim)
    h = np.zeros((p_rows, decim), dtype=np.float32)
    h.flat[:ntaps] = t
    n_rows = n_out + p_rows - 1
    need = n_rows * decim
    if need > n:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (need - n,), x.dtype)], axis=-1
        )
    X = x[..., :need].reshape(*x.shape[:-1], n_rows, decim)
    Xr = jnp.stack([X.real, X.imag], axis=-3).astype(jnp.float32)
    Z = jnp.einsum(
        "...jr,pr->...jp", Xr, jnp.asarray(h),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = Z[..., 0:n_out, 0]
    for p in range(1, p_rows):
        y = y + Z[..., p : p + n_out, p]
    return jax.lax.complex(y.take(0, axis=-2), y.take(1, axis=-2))


def _fir_polyphase(
    x: jax.Array, taps: np.ndarray, decim: int, hf: jax.Array | None = None
) -> jax.Array:
    """Polyphase decimating FIR in the platform's formulation
    (`ais_tpu.core.backend.channelizer_method`)."""
    from ais_tpu.core.backend import channelizer_method

    if channelizer_method() == "einsum":
        return _fir_polyphase_einsum(x, taps, decim)
    return _fir_polyphase_fft(x, taps, decim, hf)


def _fir_polyphase_fft(
    x: jax.Array, taps: np.ndarray, decim: int, hf: jax.Array | None = None
) -> jax.Array:
    """Polyphase decimating FIR in the frequency domain.

    With k = p*D + r:  y[m] = sum_r (x_r star h_r)[m], where
    x_r[j] = x[j*D + r] (a reshape) and h_r[p] = taps[p*D + r].  All D
    phase correlations share one FFT length, so the per-phase products
    are summed *in the frequency domain* and a single IFFT produces the
    decimated output:  y = IFFT( sum_r FFT(x_r) * FFT(rev h_r) ).

    This formulation uses only batched pow2 FFTs, broadcasts, and
    reductions: O(n log n) work per output instead of the einsum's
    O(ntaps).
    """
    t = np.asarray(taps, dtype=np.float32)
    ntaps = int(t.size)
    n = x.shape[-1]
    n_out = (n - ntaps) // decim + 1
    p_rows = -(-ntaps // decim)  # taps per phase (ceil)
    h = np.zeros((p_rows, decim), dtype=np.float32)
    h.flat[:ntaps] = t
    n_rows = n_out + p_rows - 1
    need = n_rows * decim
    if need > n:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (need - n,), x.dtype)], axis=-1
        )
    X = x[..., :need].reshape(*x.shape[:-1], n_rows, decim)
    nfft = 1 << (n_rows + p_rows - 2).bit_length()
    if hf is None:
        from ais_tpu.ops.cplx import const_complex

        hf = const_complex(
            np.fft.fft(h[::-1, :].T, nfft, axis=-1).astype(np.complex64)
        )

    # Zero-pad rows to nfft and move the phase axis ahead of time, on
    # the real and imaginary planes separately.
    def pad_t(plane):
        z = jnp.zeros(plane.shape[:-2] + (nfft - n_rows, decim), plane.dtype)
        return jnp.moveaxis(jnp.concatenate([plane, z], axis=-2), -1, -2)

    Xt = jax.lax.complex(pad_t(X.real), pad_t(X.imag))  # (..., D, nfft)
    F = jnp.fft.fft(Xt, axis=-1)
    Y = _csum_products(F, hf)
    y = _ifft_batch_safe(Y)
    from ais_tpu.ops.framing import slice_last

    return slice_last(y, p_rows - 1, p_rows - 1 + n_out).astype(jnp.complex64)


def freq_xlating_polyphase(
    x: jax.Array,
    carriers: jax.Array,
    phase0s: jax.Array,
    taps: np.ndarray,
    decim: int,
    hf: jax.Array,
    method: str | None = None,
) -> jax.Array:
    """Fused multi-channel mixer + polyphase decimating FIR.

    x: (n,) complex64; carriers: (n_chan, n) mixer carriers; phase0s:
    (n_chan,) start phases; hf: tap spectra from `polyphase_spectra`.
    Returns (n_chan, n_out).

    The mix happens after reshaping to the (rows, decim) polyphase
    layout, which is what the FFT stage needs anyway.  `method`
    ("einsum" | "fft") names the filter formulation; None takes the
    platform's (`ais_tpu.core.backend.channelizer_method`).
    """
    from ais_tpu.core.backend import channelizer_method

    from ais_tpu.ops.cplx import as_complex_input

    x = as_complex_input(x)
    carriers = as_complex_input(carriers)
    hf = as_complex_input(hf)
    t = np.asarray(taps, dtype=np.float32)
    ntaps = int(t.size)
    n = x.shape[-1]
    if n % decim != 0:
        # Callers align the input length; padding here would copy the
        # whole multi-million-sample input.
        raise ValueError(f"input length {n} must be a multiple of decim {decim}")
    n_out = n // decim - (-(-ntaps // decim)) + 1
    p_rows = -(-ntaps // decim)
    n_rows = n_out + p_rows - 1
    assert n_rows * decim == n

    X = x.reshape(n_rows, decim)
    n_chan = phase0s.shape[0]
    # Carriers arrive flat (n_chan*n,) or (n_chan, n).
    C = carriers.reshape(n_chan, n_rows, decim)
    nfft = hf.shape[-1]
    rot = jax.lax.complex(jnp.cos(phase0s), jnp.sin(phase0s))
    mixed = X[None, :, :] * C * rot[:, None, None]
    method = channelizer_method() if method is None else method
    if method == "einsum":
        return _fir_polyphase_einsum(
            mixed.reshape(n_chan, n), taps, decim
        ).astype(jnp.complex64)
    if method != "fft":
        raise ValueError(f"unknown channelizer formulation {method!r}")

    # Zero-pad rows to nfft and move the phase axis ahead of time, on
    # the real and imaginary planes separately.
    def pad_t(plane):
        z = jnp.zeros((n_chan, nfft - n_rows, decim), plane.dtype)
        return jnp.moveaxis(jnp.concatenate([plane, z], axis=-2), -1, -2)

    Xt = jax.lax.complex(pad_t(mixed.real), pad_t(mixed.imag))  # (n_chan, D, nfft)
    F = jnp.fft.fft(Xt, axis=-1)
    Y = _csum_products(F, hf)
    y = _ifft_batch_safe(Y)
    from ais_tpu.ops.framing import slice_last

    return slice_last(y, p_rows - 1, p_rows - 1 + n_out).astype(jnp.complex64)


def _fir_filter_conv(x: jax.Array, taps: np.ndarray, decim: int = 1) -> jax.Array:
    """Reference implementation via conv_general_dilated (CPU-friendly)."""
    ntaps = int(np.asarray(taps).size)
    taps_f = jnp.asarray(np.asarray(taps, dtype=np.float32)).reshape(1, 1, ntaps)
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    xr = jnp.stack([x.real, x.imag], axis=-2).reshape(-1, 1, n)
    out = jax.lax.conv_general_dilated(
        xr.astype(jnp.float32),
        taps_f,
        window_strides=(decim,),
        padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32,
    )
    n_out = out.shape[-1]
    out = out.reshape(*batch_shape, 2, n_out)
    return jax.lax.complex(out[..., 0, :], out[..., 1, :])


@functools.lru_cache(maxsize=32)
def _mixer_carrier(offset_hz: float, sample_rate: float, length: int) -> np.ndarray:
    """e^{-j 2 pi f n / fs} for n in [0, length), float64-accurate."""
    n = np.arange(length, dtype=np.float64)
    phase = -2.0 * np.pi * (offset_hz / sample_rate) * n
    return np.exp(1j * np.remainder(phase, 2.0 * np.pi)).astype(np.complex64)


def mixer_phase(offset_hz: float, sample_rate: float, start_sample) -> np.ndarray:
    """Starting phase (radians) of the down-mixer at absolute sample index.

    Host-side float64 so multi-block streaming keeps a phase-continuous
    carrier, like the reference's single rotator does implicitly.
    """
    start = np.asarray(start_sample, dtype=np.float64)
    return np.remainder(-2.0 * np.pi * (offset_hz / sample_rate) * start, 2.0 * np.pi).astype(
        np.float32
    )


def freq_xlating_fir_decimate(
    x: jax.Array,
    taps: np.ndarray,
    offset_hz: float,
    sample_rate: float,
    decim: int,
    phase0: jax.Array | float = 0.0,
    carrier: jax.Array | None = None,
) -> jax.Array:
    """Mix `x` down by `offset_hz`, low-pass with `taps`, decimate.

    x: (..., n) complex64. phase0: scalar or (batch,) carrier start phase
    (from `mixer_phase`).  Output: (..., (n - ntaps)//decim + 1).

    `carrier` may supply the e^{-j w n} array explicitly (e.g. a
    device-resident buffer passed as a jit argument instead of a
    multi-MB program constant).
    """
    n = x.shape[-1]
    if carrier is None:
        from ais_tpu.ops.cplx import const_complex

        carrier = const_complex(_mixer_carrier(offset_hz, sample_rate, n))
    ph = jnp.asarray(phase0, dtype=jnp.float32)
    rot = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    if jnp.ndim(rot):
        rot = rot.reshape(rot.shape + (1,) * (x.ndim - rot.ndim))
    mixed = x * carrier * rot
    return fir_filter(mixed, taps, decim)
