"""Device FFTs (XLA's FFT through jnp.fft) must match numpy's FFT closely
enough for the timestream round trip, at even, odd, prime and long
lengths, along either axis."""

import numpy as np
import pytest

import driftscan_tpu.backend as backend


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("n", [8, 63, 461, 4099])  # even, odd, prime, > 4096
def test_fft_matches_numpy(n, axis):
    rng = np.random.default_rng(n)
    shape = (n, 3) if axis == 0 else (3, n)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    np.testing.assert_allclose(
        backend.fft(x, axis=axis), np.fft.fft(x, axis=axis),
        rtol=1e-10, atol=1e-9 * n,
    )
    np.testing.assert_allclose(
        backend.ifft(x, axis=axis), np.fft.ifft(x, axis=axis),
        rtol=1e-10, atol=1e-9,
    )


def test_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 97)) + 1j * rng.standard_normal((2, 97))
    np.testing.assert_allclose(backend.ifft(backend.fft(x)), x, atol=1e-9)
