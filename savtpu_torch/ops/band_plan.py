"""The launch plan of the two banded kernels, K3 (``online_banded``) and
K4 (``banded_scan``).

Both run one part per thread block cluster of B blocks (``csrc/
common.cuh``): block b owns rows [b R, b R + R) of the part's DLB = nc Bk,
R = ceil(DLB / B), keeps as many of its Kd rows in shared memory as fit
beside its state (the resident rows) and streams the rest of its band.
The plan is plain Python so that the CPU tests can check it;
:func:`band_layout_bytes` mirrors ``band_layout`` in ``common.cuh``, and
the launch refuses a plan whose size differs from the kernel's own.

:func:`band_plan` picks B from the card's SM count and a table of how many
clusters of each size the card runs at once
(``cudaOccupancyMaxActiveClusters``, read by :func:`cluster_table`): the
largest B <= 16 whose P clusters all run at once; else one block per part
(B = 1, clusters in waves), or, where one block cannot hold a part's
state, the smallest B that can.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import kernels

NT = 1024                   # threads per block (BAND_NT)
NW = NT // 32
MAX_CLUSTER = 16            # H100, non-portable cluster sizes allowed


@dataclass(frozen=True)
class BandPlan:
    """How K3 or K4 is launched: ``blocks`` blocks per part (the cluster
    size), each owning ``rows`` consecutive rows (the last may own fewer),
    the first ``resident`` of its Kd rows kept in shared memory, gathering
    the operand over at most ``window`` rows, with ``smem`` bytes of
    dynamic shared memory per block."""

    blocks: int
    rows: int
    resident: int
    window: int
    smem: int


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _spans(nc: int, Bk: int, blocks: int):
    """(first chunk, last chunk) of each block's rows."""
    DLB = nc * Bk
    R = -(-DLB // blocks)
    return [(r0 // Bk, (min(DLB, r0 + R) - 1) // Bk)
            for r0 in range(0, DLB, R)]


def band_window(nc: int, Bk: int, blocks: int) -> int:
    """The longest operand window of a block: its rows' chunks and the
    chunk before them."""
    return max((c1 + 1 - max(0, c0 - 1)) * Bk
               for c0, c1 in _spans(nc, Bk, blocks))


def band_layout_bytes(nc: int, Bk: int, it: int, blocks: int,
                      resident: int) -> int:
    """Dynamic shared memory of one block (``band_layout`` in
    ``csrc/common.cuh``): resident Kd rows, the operand and real-DOF mask
    windows, the double-buffered exchange (rows and 3 partial sums), 6
    per-row arrays, the row products' partial sums per column group, the
    transposed term's partial sums per row slice, the block's published
    transposed sums (one chunk row per chunk it spans), the reductions,
    and the int slot map."""
    R = -(-nc * Bk // blocks)
    W = band_window(nc, Bk, blocks)
    nseg = max(c1 - c0 + 1 for c0, c1 in _spans(nc, Bk, blocks))
    vw = 16 // it
    n = (resident * Bk + 2 * _pad4(W) + 2 * _pad4(R + 3) + 6 * _pad4(R)
         + Bk // (32 * vw) * _pad4(R) + NW * 32 * vw + nseg * Bk
         + _pad4(3 * NW + 3))
    return n * it + 4 * _pad4(R)


def forced_band_plan(nc: int, Bk: int, dtype, blocks: int,
                     resident: int | None = None,
                     smem_per_block: int = kernels.SMEM_PER_BLOCK
                     ) -> BandPlan:
    """The plan with ``blocks`` blocks per part and ``resident`` Kd rows
    in shared memory (default: as many of a block's rows as fit in
    ``smem_per_block`` beside its state); :func:`band_plan` picks among
    these."""
    if not 1 <= blocks <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} blocks, not "
                         f"{blocks}")
    it = _itemsize(dtype)
    R = -(-nc * Bk // blocks)
    if resident is None:
        free = smem_per_block - band_layout_bytes(nc, Bk, it, blocks, 0)
        resident = min(R, max(0, free // (Bk * it)))
    if not 0 <= resident <= R:
        raise ValueError(f"resident rows {resident} outside 0..{R}")
    return BandPlan(blocks, R, resident, band_window(nc, Bk, blocks),
                    band_layout_bytes(nc, Bk, it, blocks, resident))


def band_plan(P: int, nc: int, Bk: int, dtype, sm_count: int,
              max_clusters: dict,
              smem_per_block: int = kernels.SMEM_PER_BLOCK) -> BandPlan:
    """K3's and K4's launch for P parts of nc chunks of Bk rows on a card
    with ``sm_count`` SMs, where ``max_clusters[B]`` clusters of B blocks
    (each with a full block's shared memory) run at once:

    - the largest B in 2..16 with P B <= sm_count and max_clusters[B] >= P
      (all P clusters in one wave), resident rows as many as fit;
    - else B = 1, one block per part, where its state fits a block;
    - else the smallest B whose state fits (clusters in waves)."""
    for B in range(MAX_CLUSTER, 1, -1):
        if P * B <= sm_count and max_clusters.get(B, 0) >= P:
            plan = forced_band_plan(nc, Bk, dtype, B,
                                    smem_per_block=smem_per_block)
            if plan.smem <= smem_per_block:
                return plan
    for B in range(1, MAX_CLUSTER + 1):
        plan = forced_band_plan(nc, Bk, dtype, B,
                                smem_per_block=smem_per_block)
        if plan.smem <= smem_per_block:
            return plan
    raise ValueError(f"no cluster of up to {MAX_CLUSTER} blocks holds a "
                     f"part of {nc} x {Bk} rows")


def check_band_plan(what: str, plan: BandPlan, nc: int, Bk: int,
                    dtype) -> None:
    """Raise unless ``plan`` is a launch shape of nc x Bk rows that fits
    a block's shared memory (what :func:`forced_band_plan` gives for its
    blocks and resident rows)."""
    try:
        expect = forced_band_plan(nc, Bk, dtype, plan.blocks, plan.resident)
    except ValueError as err:
        raise ValueError(f"{what}: {plan} does not fit: {err}") from None
    if plan != expect or plan.smem > kernels.SMEM_PER_BLOCK:
        raise ValueError(f"{what}: {plan} does not fit {nc} x {Bk} rows "
                         f"in {kernels.SMEM_PER_BLOCK} bytes (expected "
                         f"{expect})")


def check_band_operands(what: str, Kd: torch.Tensor, Kl: torch.Tensor):
    """Raise unless the kernels can split the band's rows into whole
    warps of 16-byte loads: Bk a multiple of 128 up to 2048 (the band
    builder makes it a multiple of 256) and both blocks 16-byte
    aligned."""
    Bk = Kd.shape[-1]
    if Bk % 128 or Bk > 2048 or Kd.data_ptr() % 16 or Kl.data_ptr() % 16:
        raise ValueError(f"{what}: the band needs Bk a multiple of 128 up "
                         f"to 2048 and 16-byte aligned Kd, Kl (Bk = {Bk})")


_TABLES: dict = {}


def cluster_table(name: str, dtype, device) -> dict:
    """{B: clusters of B blocks that run at once} for B = 1..16, from
    ``cudaOccupancyMaxActiveClusters`` for ``csrc/<name>.cu``'s kernel
    with a full block's shared memory (0 where the card refuses the
    size). Cached per kernel, dtype and device."""
    key = (name, dtype, torch.device(device).index)
    table = _TABLES.get(key)
    if table is None:
        fn = kernels.function(
            name, f"savtpu_{name}_max_clusters_{kernels.suffix(dtype)}",
            [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        table = {}
        with torch.cuda.device(device):
            for B in range(1, MAX_CLUSTER + 1):
                out = ctypes.c_int(0)
                err = fn(B, kernels.SMEM_PER_BLOCK, ctypes.byref(out))
                table[B] = out.value if err == 0 else 0
        _TABLES[key] = table
    return table
