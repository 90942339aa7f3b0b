"""Wrappers of the radix planner's CUDA kernels (``csrc/radix_sort.cu``).

``digit_block_histogram`` (B1) and ``digit_placement`` (B2) are the
counterparts of the Pallas kernels of the same names in
``repro/kernels/radix_sort/radix_sort.py``.  Two layout differences:
the histogram is digit-major (``[nbins, nblocks]``) so one flat
exclusive scan yields every block's per-digit base, and the placement
scatters the payload (and any carried words) straight to its landing
position instead of returning the positions.

Each wrapper takes its plain version (:mod:`.ref`) for a CPU tensor and
launches its kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ...sparse import tuning
from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import digit_block_histogram_ref, digit_placement_ref, hist_runs

#: keys per thread block (256 threads x 16) -- fixed by the kernel source;
#: the ``radix_sort`` spec's build-time ``tile``
TILE = tuning.prior_value("radix_sort", "tile")
#: widest digit the kernels take: 2^8 bins of shared-memory counters
KERNEL_MAX_BITS = tuning.prior_value("radix_sort", "kernel_max_bits")
#: words B2 carries beside the payload, fixed by the kernel source
KERNEL_MAX_CARRY = 2
#: B1 blocks resident on an SM: its grid is at most one such wave
#: (:func:`.ref.hist_runs`); the ``radix_sort`` spec's ``hist_per_sm``
HIST_PER_SM = tuning.prior_value("radix_sort", "hist_per_sm")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("radix_sort")
        for fn in ("radix_tile", "radix_max_bins", "radix_max_carry",
                   "radix_hist_per_sm", "radix_hist_chunk"):
            bind(lib, fn, [])
        bind(lib, "radix_hist_run", [_I, _I])
        built = tuning.build_knobs("radix_sort")
        if (lib.radix_tile() != built["tile"]
                or lib.radix_max_bins() != 1 << built["kernel_max_bits"]
                or lib.radix_max_carry() != KERNEL_MAX_CARRY
                or lib.radix_hist_per_sm() != built["hist_per_sm"]
                or lib.radix_hist_chunk() != built["hist_chunk"]):
            raise RuntimeError("csrc/radix_sort.cu tile, bins, carry "
                               "count or B1's wave or chunk differs from "
                               "the radix_sort tuning spec or "
                               "KERNEL_MAX_CARRY")
        # B1's runs: the C side's rule is hist_runs'
        for nblocks, sms in ((1, 1), (611, 132), (612, 132), (12_208, 132),
                             (2**15, 144), (2**15 + 1, 1)):
            if lib.radix_hist_run(nblocks, sms) != hist_runs(
                    nblocks, sms, built["hist_per_sm"])[0]:
                raise RuntimeError("csrc/radix_sort.cu hist_run() differs "
                                   "from ref.hist_runs")
        _FNS["hist"] = bind(lib, "digit_histogram_launch",
                            [_P, _P, _LL, _I, _I, _I, _I, _P])
        _FNS["place"] = bind(lib, "digit_placement_launch",
                             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I,
                              _I, _I, _I, _P])
    return _FNS


def _check_digit(keys: torch.Tensor, bits: int, nbins: int) -> None:
    check_cuda_tensor(keys, "keys", (torch.int32,))
    L = keys.shape[0]
    if keys.ndim != 1 or L == 0 or L >= 2**31:
        raise ValueError(f"keys must be 1-d with 0 < L < 2^31, got "
                         f"{tuple(keys.shape)}")
    if not 1 <= bits <= KERNEL_MAX_BITS or not 1 <= nbins <= 1 << bits:
        raise ValueError(f"need 1 <= bits <= {KERNEL_MAX_BITS} and "
                         f"1 <= nbins <= 2^bits, got bits={bits}, "
                         f"nbins={nbins}")


def digit_block_histogram(keys: torch.Tensor, *, shift: int, bits: int,
                          nbins: int) -> torch.Tensor:
    """B1: ``int32[nbins, nblocks]`` histogram of ``(keys >> shift) &
    (2^bits - 1)`` per block of :data:`TILE` keys (digit-major).

    One launch; each CUDA block counts a run of tiles
    (:func:`.ref.hist_runs` on the card's SM count)."""
    if keys.device.type == "cpu":
        return digit_block_histogram_ref(keys, shift=shift, bits=bits,
                                         nbins=nbins, tile=TILE)
    _check_digit(keys, bits, nbins)
    L = keys.shape[0]
    nblocks = cdiv(L, TILE)
    hist = torch.empty((nbins, nblocks), dtype=torch.int32,
                       device=keys.device)
    check_launch(_fns()["hist"](keys.data_ptr(), hist.data_ptr(), L, shift,
                                bits, nbins, nblocks,
                                current_stream(keys.device)),
                 "digit_block_histogram")
    digit_block_histogram.launches += 1
    return hist


def digit_placement(keys: torch.Tensor, base: torch.Tensor,
                    payload: torch.Tensor | None = None, *,
                    carry: tuple = (), shift: int, bits: int, nbins: int):
    """B2: one stable counting-sort pass of ``payload`` by the digit.

    ``base`` is the exclusive scan of :func:`digit_block_histogram`'s
    flattened output; ``payload=None`` scatters the input positions
    ``0..L-1`` (the first pass of a sort).  Returns the new ``int32[L]``
    stream.  ``carry`` is up to :data:`KERNEL_MAX_CARRY` more ``int32[L]``
    words (``keys`` itself among them, if wanted) moved the same way;
    with any, the return is ``(stream, carried)``, ``carried[c]`` being
    ``carry[c]`` in the new order.  Positions of keys whose digit is
    ``>= nbins`` are never written.
    """
    carry = tuple(carry)
    if keys.device.type == "cpu":
        return digit_placement_ref(keys, base, payload, carry=carry,
                                   shift=shift, bits=bits, nbins=nbins,
                                   tile=TILE)
    _check_digit(keys, bits, nbins)
    L = keys.shape[0]
    nblocks = cdiv(L, TILE)
    check_cuda_tensor(base, "base", (torch.int32,))
    if base.numel() != nbins * nblocks:
        raise ValueError(f"base has {base.numel()} entries, expected "
                         f"nbins * nblocks = {nbins * nblocks}")
    if len(carry) > KERNEL_MAX_CARRY:
        raise ValueError(f"at most {KERNEL_MAX_CARRY} carried words, got "
                         f"{len(carry)}")
    for name, word in (("payload", payload),
                       *((f"carry[{c}]", w) for c, w in enumerate(carry))):
        if word is not None:
            check_cuda_tensor(word, name, (torch.int32,))
            if word.shape != keys.shape:
                raise ValueError(f"{name} must have the keys' shape")
    out = torch.empty(L, dtype=torch.int32, device=keys.device)
    moved = tuple(torch.empty_like(out) for _ in carry)
    ins = [w.data_ptr() for w in carry] + [None] * (2 - len(carry))
    outs = [w.data_ptr() for w in moved] + [None] * (2 - len(carry))
    check_launch(_fns()["place"](
        keys.data_ptr(), base.data_ptr(),
        None if payload is None else payload.data_ptr(), out.data_ptr(),
        *ins, *outs, len(carry), L, shift, bits, nbins, nblocks,
        current_stream(keys.device)), "digit_placement")
    digit_placement.launches += 1
    return (out, moved) if carry else out


digit_block_histogram.launches = 0
digit_placement.launches = 0
