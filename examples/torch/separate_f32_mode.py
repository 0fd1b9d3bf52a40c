"""complex64 class-API run with the float32-calibrated flooring, on the card by default.

A user in single precision: the whole class pipeline in complex64 on a
high-dynamic-range mixture (the spectrogram under a strong spectral
rolloff). The reference's default eps=1e-10 flooring is calibrated for
float64 and goes non-finite here after ~150 iterations; ``flooring_fn="f32"``
(or ``"dtype"``) selects eps=1e-6. In complex64 the class runs on the
hand-written kernels: the weighted covariance K1 and the IP1 sweep K1b once
each an iteration, 200 iterations.

    python examples/torch/separate_f32_mode.py
    python examples/torch/separate_f32_mode.py --device cpu
"""

import numpy as np

from _common import make_mixture, parser, report

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy (float64)."""
    import torch

    from ssspy_tpu_torch.bss import AuxIVA
    from ssspy_tpu_torch.transform import istft, stft

    X = stft(mix, n_fft=512, hop_length=256, device=device).to(torch.complex64)
    # strong spectral rolloff = the high-dynamic-range case
    rolloff = 10.0 ** (-3.0 * np.arange(X.shape[1]) / X.shape[1])
    X = X * torch.from_numpy(rolloff[None, :, None].astype(np.complex64)).to(X.device)

    iva = AuxIVA(
        spatial_algorithm="IP1",
        flooring_fn="f32",  # <- the one knob a complex64 run needs
        contrast_fn=lambda y: 2 * torch.linalg.norm(y, dim=1),
        d_contrast_fn=lambda y: 2 * torch.ones_like(y),
        device=device,
    )
    Y = iva(X, n_iter=200)
    assert bool(torch.isfinite(torch.view_as_real(Y)).all()), "diverged"
    print(f"200 complex64 iterations finite; loss {iva.loss[0]:.1f} -> {iva.loss[-1]:.1f}")

    Y = Y.to(torch.complex128) / torch.from_numpy(rolloff[None, :, None]).to(Y.device)
    return istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=Y.device).cpu().numpy()


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, device=args.device)
    report(y, images, mix)


if __name__ == "__main__":
    main()
