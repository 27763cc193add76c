"""DFT as matmuls on split real/imag float32 — no complex dtype on device.

The per-symbol 2048-point FFT is the acquisition's inner loop. Expressing it
as a two-stage Cooley-Tukey with dense DFT factor matrices turns it into
large batched real matmuls (SURVEY.md sec 7 roofline item) on split parts,
so the acquisition program needs no complex dtype. The products run at
HIGHEST precision: a TF32 product would cost the spectra their float32
accuracy.

Math (N = N1*N2, n = N2*n1 + n2, k = k1 + N1*k2):
  X[k1 + N1 k2] = sum_{n2} W_N^{n2 k1} [ sum_{n1} x[N2 n1 + n2] W_{N1}^{n1 k1} ]
                  * W_{N2}^{n2 k2}
Step 1: A[n2, n1] = x.reshape(N1, N2).T         (transpose)
Step 2: B = A @ F1          (F1 = DFT_{N1}, complex -> 4 real matmuls)
Step 3: C = B * T           (T[n2, k1] = W_N^{n2 k1}, elementwise twiddle)
Step 4: D = F2^T @ C        (F2 = DFT_{N2});  X = D.reshape(N,) row-major
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _factor(n: int):
    """Pick N1*N2 = n with both factors matmul-friendly (near sqrt, >= 8)."""
    best = None
    for n1 in range(2, n):
        if n % n1:
            continue
        n2 = n // n1
        score = abs(n1 - n2)
        if best is None or score < best[0]:
            best = (score, n1, n2)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _tables(n: int, inverse: bool):
    n1, n2 = _factor(n)
    sign = 2j if inverse else -2j
    w_n1 = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w_n2 = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    f = np.float32
    return (n1, n2,
            f(w_n1.real), f(w_n1.imag),
            f(w_n2.real), f(w_n2.imag),
            f(tw.real), f(tw.imag))


def _cmm(ar, ai, br, bi):
    """Complex matmul on split parts: (ar+i ai) @ (br+i bi)."""
    mm = lambda x, y: jax.lax.dot_general(
        x, y, dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def matfft(x_re, x_im, inverse: bool = False):
    """Batched DFT: (..., N) split re/im -> (..., N) split re/im.

    Unnormalized forward DFT (like np.fft.fft); inverse=True gives the
    unnormalized inverse (scale by 1/N for np.fft.ifft parity).
    """
    n = x_re.shape[-1]
    n1, n2, f1r, f1i, f2r, f2i, twr, twi = _tables(n, inverse)
    batch = x_re.shape[:-1]

    # Step 1: A[.., n2, n1]
    ar = jnp.swapaxes(x_re.reshape(batch + (n1, n2)), -1, -2)
    ai = jnp.swapaxes(x_im.reshape(batch + (n1, n2)), -1, -2)
    # Step 2: B = A @ F1  -> (.., n2, k1)
    br, bi = _cmm(ar, ai, jnp.asarray(f1r), jnp.asarray(f1i))
    # Step 3: twiddle
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # Step 4: D[.., k2, k1] = F2^T @ C; implement as (C^T @ F2)^T to keep
    # batched dot_general simple: D^T[k1, k2] = C^T[k1, n2] @ F2[n2, k2]
    ctr = jnp.swapaxes(cr, -1, -2)
    cti = jnp.swapaxes(ci, -1, -2)
    dtr, dti = _cmm(ctr, cti, jnp.asarray(f2r), jnp.asarray(f2i))
    # X[k1 + N1 k2] = D[k2, k1] = D^T[k1, k2] -> row-major over (k2, k1)
    xr = jnp.swapaxes(dtr, -1, -2).reshape(batch + (n,))
    xi = jnp.swapaxes(dti, -1, -2).reshape(batch + (n,))
    return xr, xi


def matfft_np(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """NumPy oracle wrapper (complex in/out) for tests."""
    re, im = matfft(jnp.asarray(x.real.astype(np.float32)),
                    jnp.asarray(x.imag.astype(np.float32)), inverse)
    return np.asarray(re) + 1j * np.asarray(im)
