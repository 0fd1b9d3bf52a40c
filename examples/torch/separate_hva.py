"""HVA: harmonic vector analysis (proximal splitting + cepstral mask), on the card by default.

Proximal-splitting methods are stable only when the PDS operator norm is
bounded — the reference ships ``normalize_by_spectral_norm`` for exactly
this, so the mixture is scaled before separation here (projection back
restores absolute scale against the original reference channel). The
class branch runs ``HVA()`` in complex128: on the card the plain PyTorch
routes, no hand-written kernel. ``--fast`` runs ``fast_hva`` in
complex64: the log-det prox through the Jacobi eigh K7 once an iteration,
100 iterations.

    python examples/torch/separate_hva.py --fast
"""

from _common import make_mixture, parser, report, save_wavs, spectral_norm_scale, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    import torch

    from ssspy_tpu_torch.transform import istft, stft

    X = stft(mix, n_fft=512, hop_length=256, device=device)
    norm = spectral_norm_scale(X)
    Xn = X / norm

    if fast:
        from ssspy_tpu_torch.fast import fast_hva

        Y, _ = fast_hva(Xn, n_iter=100, device=device)
    else:
        from ssspy_tpu_torch.bss import HVA

        hva = HVA(device=device)
        Y = hva(Xn.to(torch.complex128), n_iter=100)
    Y = Y * norm  # undo the stability scaling (PB used the scaled reference)
    return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_hva in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "hva", args.out)


if __name__ == "__main__":
    main()
