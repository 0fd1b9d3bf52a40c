"""PDSIVA / ADMMIVA: proximal-splitting IVA with the L21 penalty, on the card by default.

The mixture is scaled by its spectral norm first (the PDS/ADMM operator
norm must be bounded; the reference ships normalize_by_spectral_norm for
the same reason). ``fast_pds_iva`` or, with ``--admm``, ``fast_admm_iva``,
200 iterations in complex64: the log-det prox through the Jacobi eigh K7
once an iteration.

    python examples/torch/separate_prox_iva.py
    python examples/torch/separate_prox_iva.py --admm
"""

from _common import make_mixture, parser, report, save_wavs, spectral_norm_scale, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, admm=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    from ssspy_tpu_torch.transform import istft, stft

    X = stft(mix, n_fft=512, hop_length=256, device=device)
    norm = spectral_norm_scale(X)
    Xn = X / norm

    if admm:
        from ssspy_tpu_torch.fast import fast_admm_iva

        Y, _ = fast_admm_iva(Xn, n_iter=200, device=device)
    else:
        from ssspy_tpu_torch.fast import fast_pds_iva

        Y, _ = fast_pds_iva(Xn, n_iter=200, device=device)
    return to_numpy(istft(Y * norm, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--admm", action="store_true", help="ADMMIVA in place of PDSIVA")
    args = p.parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, admm=args.admm, device=args.device)
    report(y, images, mix)
    save_wavs(y, "admm_iva" if args.admm else "pds_iva", args.out)


if __name__ == "__main__":
    main()
