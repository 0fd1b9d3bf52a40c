"""Batch separation over a (dp, bin) layout of ranks, on the card by default.

``fast_auxiva_batch`` separates four utterances (2 sources, 2 s each) with
AuxIVA-IP1 in complex64, 50 iterations: on one card with no process group,
the utterances share each iteration's launches (the weighted covariance K1
once per utterance, the IP1 sweep K1b once for all). With ``--ranks N`` the
same call runs on N spawned ranks under one ``torch.distributed`` process
group, laid out on ``(dp, bin)`` by ``ssspy_tpu_torch.parallel.make_layout``
(2 -> (1, 2): the bins split over two ranks, whose cross-bin sums go
through one all-reduce an iteration). The ranks take gloo and share the
card (or the CPU with ``--device cpu``); where each rank has a card of its
own they take NCCL. The STFT's 128 bins (``n_fft=254``) divide the bin axis
evenly.

    python examples/torch/batch_mesh.py
    python examples/torch/batch_mesh.py --ranks 2
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

N_FFT, HOP, N_ITER = 254, 128, 50
MIXTURE, SEEDS = dict(n_sources=2, duration=2.0), range(4)  # four utterances: make_mixture's keywords and seeds


def separate_batch(X, device):
    """``fast_auxiva_batch`` on ``X`` ``(B, M, I, T)``, the separated spectrograms as numpy: what each rank runs."""
    from ssspy_tpu_torch.fast import fast_auxiva_batch

    Y, _ = fast_auxiva_batch(X, n_iter=N_ITER, device=device)
    return Y.cpu().numpy()


def run(mixes, *, ranks=1, device="cuda"):
    """The separated waveforms ``(B, n_sources, n_samples)`` of the mixtures ``(B, n_channels, n_samples)``, as numpy."""
    import torch

    from ssspy_tpu_torch.transform import istft, stft

    X = stft(np.stack(mixes), n_fft=N_FFT, hop_length=HOP, device=device)
    print(f"batch {tuple(X.shape)} over {ranks} rank(s)")
    if ranks > 1:
        from ssspy_tpu_torch.parallel.dryrun import spawn

        Y = spawn(ranks, separate_batch, (X.cpu().numpy(), str(X.device)), device=X.device)[0]
    else:
        Y = separate_batch(X, X.device)
    Y = torch.from_numpy(Y).to(X.device)
    return istft(Y, n_fft=N_FFT, hop_length=HOP, length=mixes[0].shape[-1], device=X.device).cpu().numpy()


def main(argv=None):
    from _common import make_mixture, parser, report

    p = parser(__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=1, help="spawned ranks under one process group (default: 1, no group)")
    args = p.parse_args(argv)
    mixes, images = zip(*(make_mixture(**MIXTURE, seed=seed) for seed in SEEDS))
    y = run(mixes, ranks=args.ranks, device=args.device)
    for b in range(len(mixes)):
        report(y[b], images[b], mixes[b])


if __name__ == "__main__":
    main()
