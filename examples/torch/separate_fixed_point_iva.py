"""FastIVA / FasterIVA: whitened fixed-point IVA (Laplace contrast), on the card by default.

By default ``fast_fast_iva`` or, with ``--faster``, ``fast_faster_iva``, 50
iterations in complex64: the whitening and each step's polar factor
through the Jacobi eigh K7, and FasterIVA's per-source covariance through
the weighted covariance K1 and its top eigenvectors through K7 once more a
step. ``--class`` runs ``FastIVA`` / ``FasterIVA`` through ``separate`` in
float64 / complex128: on the card the plain PyTorch routes, no
hand-written kernel.

    python examples/torch/separate_fixed_point_iva.py
    python examples/torch/separate_fixed_point_iva.py --faster
"""

from _common import make_mixture, parser, report, save_wavs, to_numpy

# fixed-point IVA is at its best on (near-)determined 2-source scenes
MIXTURE = dict(n_sources=2, duration=3.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, faster=False, use_class=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if use_class:
        import torch

        from ssspy_tpu_torch import separate
        from ssspy_tpu_torch.bss import FasterIVA, FastIVA

        contrasts = dict(
            contrast_fn=lambda y: 2 * torch.linalg.norm(y, dim=1),
            d_contrast_fn=lambda y: 2 * torch.ones_like(y),
        )
        if faster:
            iva = FasterIVA(**contrasts, device=device)
        else:
            iva = FastIVA(dd_contrast_fn=lambda y: torch.zeros_like(y), **contrasts, device=device)
        return to_numpy(separate(mix, iva, n_iter=50, device=device))

    from ssspy_tpu_torch.fast import fast_fast_iva, fast_faster_iva
    from ssspy_tpu_torch.transform import istft, stft

    X = stft(mix, n_fft=512, hop_length=256, device=device)
    Y = (fast_faster_iva if faster else fast_fast_iva)(X, n_iter=50, device=device)
    return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--faster", action="store_true", help="FasterIVA in place of FastIVA")
    p.add_argument("--class", dest="use_class", action="store_true",
                   help="the class API in complex128 in place of the complex64 fast path")
    args = p.parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, faster=args.faster, use_class=args.use_class, device=args.device)
    report(y, images, mix)
    save_wavs(y, f"{'faster' if args.faster else 'fast'}_iva", args.out)


if __name__ == "__main__":
    main()
