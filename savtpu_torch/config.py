"""Single configuration object shared by every pipeline stage.

A copy of ``savtpu/config.py``: the same dataclasses, so one JSON file
drives both the JAX package and this port.

The reference hardcodes and *duplicates* all constants between its four stage
scripts (Data_prepare.py:35-50, Online_predictor.py:37-63, Model_training.py:19-46,
and again inside DNN_prediction.py:21-24) — a documented drift hazard
(SURVEY.md §5). Here one dataclass owns every knob; stages receive the same
instance, and a JSON round-trip gives a file-based config system.

Defaults reproduce the reference benchmark configuration exactly
(BASELINE.md): E=1e6, nu=0.3, rho=1, fz=0.5, alpha=0.5, ramped load,
gamma=0.9, 1e5 steps, n_p=n_f=20, n_s=150, n_ts=0.5, nH=50, nB=10,
Adam 5e-4 -> 5e-7 with decay 0.998.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class MaterialConfig:
    """Isotropic linear elasticity (reference Tools/commons.py:15-41)."""

    E: float = 1e6            # Young's modulus
    nu: float = 0.3           # Poisson ratio
    rho: float = 1.0          # density
    fz: float = 0.5           # body-force magnitude, applied as (0, -fz, -fz)
    ramped: bool = True       # linear_ramp(t) on the load, ends at t=1s
    model: str = "linear"     # "linear" | "neo_hookean" (stretch goal)

    @property
    def lmd(self) -> float:
        return self.E * self.nu / ((1 + self.nu) * (1 - 2 * self.nu))

    @property
    def mu(self) -> float:
        return self.E / (2 * (1 + self.nu))


@dataclass
class SolverConfig:
    """Explicit dynamics (reference Data_prepare.py:43-50)."""

    alpha: float = 0.5        # mass-proportional damping (C = alpha*M)
    gamma: float = 0.9        # CFL reduction factor
    num_steps: int = 100_000  # total explicit steps
    save_every: int = 1       # trajectory save stride
    deg: int = 1              # polynomial order (P1 tets; P2 steady-only)
    n_quad: int = 2           # quadrature accuracy key (2 -> 4-pt rule)
    fint_mode: str = "auto"   # "dense" | "banded" | "ell" | "ebe" |
                              # "pallas" | "stencil" (gather-free linear
                              # forces on structured box partitions; pair
                              # with exchange_mode="grid") | "auto"
    exchange_mode: str = "psum"  # halo exchange: "psum" (global shared
                                 # all-reduce) | "permute" (neighbor-packed
                                 # collective_permute rounds) | "grid"
                                 # (structured box partitions only:
                                 # dimension-split face-plane sums, zero
                                 # gather/scatter — beats the XLA scatter
                                 # floor on one chip; pair with
                                 # partition.method="box")
    dtype: str = "float64"    # state dtype for the time loop
    # double-word (hi, lo) state roll: f64-class trajectories on TPU
    # hardware that has no float64 (docs/PRECISION.md). None = auto:
    # on for float32 runs (zero measured cost, ~800x trajectory
    # accuracy), off for float64 (already at the fp noise floor; keeps
    # strict formula parity with the f64 reference).
    compensated: Optional[bool] = None
    # mid-run checkpointing (savtpu extension; the reference restarts only
    # from complete artifacts, SURVEY.md §5): persist the scan carry and
    # the recorded trajectory every ckpt_every steps in stages 1 and 4;
    # a killed run resumes bit-exactly from the last checkpoint. 0 = off.
    ckpt_every: int = 0
    # neo-Hookean structured-box stencil force kernel (parallel/stencil.py):
    # "auto" upgrades the matrix-free nh path to gather-free shifted-slice
    # stencils when the mesh+partition are box-eligible; "off" forces the
    # generic gather path (any unstructured mesh).
    nh_stencil: str = "auto"


@dataclass
class PartitionConfig:
    n_parts: int = 2
    method: str = "rcb"       # "rcb" | "graph" (native C++) | "slab" |
                              # "box" (equal-box grid on structured
                              # meshes: minimal-cut divisible
                              # factorization, stencil-NH-eligible;
                              # falls back to rcb off-grid)
    dirichlet_axis: int = 0   # clamped face: coordinate == dirichlet_value
    dirichlet_value: float = 0.0
    dirichlet_tol: float = 1e-9


@dataclass
class SurrogateConfig:
    """LSTM encoder-decoder + schedule (reference Model_training.py:19-46,
    Online_predictor.py:56-63)."""

    hidden_size: int = 50           # n_H
    num_layers_encoder: int = 2
    bidirectional: bool = True
    dropout_encoder: float = 0.0
    dropout_decoder: float = 0.0
    n_past: int = 20                # n_p
    n_future: int = 20              # n_f
    filter_size: int = 150          # n_s (temporal stride)
    cut_off: float = 0.5            # n_ts (fraction of trace used for training)
    batch_size: int = 10            # n_B
    learning_rate: float = 5e-4
    lr_min: float = 5e-7
    decay: float = 0.998            # per-epoch exponential decay
    train_portion: float = 0.75
    num_epochs: Optional[int] = None  # None -> int(log(lr_min/lr, decay)) = 3450
    seed: int = 0
    dtype: str = "float32"
    # stage-4 device-resident history carry dtype (None = dtype). The
    # carry is (P, n_past*filter_size, S3max) — 2.3 GB f32 at 384^3/256
    # — and the per-block concat doubles it transiently; "bfloat16"
    # halves both. For arch="hybrid" the rows are RESIDUALS (~1e-3 of
    # signal), so bf16's ~0.4% relative noise lands at ~1e-6 of signal.
    hist_dtype: Optional[str] = None
    resync_blocks: int = 0          # EXPERIMENTAL, measured HARMFUL: one
                                    # exchanged block (shared DOFs blended
                                    # prediction->dynamics) every N
                                    # predicted blocks. The comm-free
                                    # interior accumulates elastic
                                    # mismatch against the prescribed
                                    # boundary; ANY return to exchanged
                                    # dynamics releases it as ringing
                                    # (hard release: x10-30/block to inf;
                                    # smoothstep-blended release: still
                                    # divergent at 16 shards, and 16x
                                    # WORSE than no resync even at
                                    # 48x4x4/8 where predictions are
                                    # 1%-accurate). Keep 0; see
                                    # docs/STATUS_r2.md.
    pred_smooth: int = 0            # moving-average window (steps) applied
                                    # to the predicted shared-DOF block
                                    # along time. The 150 phase-offset
                                    # models are independent, so adjacent
                                    # block rows carry row-to-row jitter —
                                    # content above the coarse-grid Nyquist
                                    # 1/(filter_size*dt) that the models
                                    # cannot represent and the
                                    # near-undamped modes amplify. 0 = off
                                    # (reference behavior); filter_size is
                                    # the principled choice.
    scale_mode: str = "joint"       # feature scaling: "joint" (reference
                                    # Scale_to_zero_one) | "per_feature"
                                    # (per-DOF min/max — required for
                                    # small-amplitude interface traces at
                                    # high shard counts, models/data.py)
    epoch_chunk: int = 250          # stacked training epochs per device
                                    # dispatch (bit-identical to unchunked;
                                    # bounds single-dispatch wall time so
                                    # remote workers' watchdogs don't trip)
    training_method: str = "recursive"  # "recursive" | "mtf" (mixed
                                        # teacher forcing, working version
                                        # of the reference's unused branch)
    tf_ratio: float = 0.6               # initial teacher-forcing ratio
                                        # (Model_training.py:46), decays
                                        # 0.005/batch like the reference
    stacked: Optional[bool] = None  # train all shards' models in one
                                    # vmapped pass (features padded to the
                                    # max shard width). None = auto: True
                                    # when n_parts > 1 (the fast path —
                                    # one compiled program instead of one
                                    # retrace per distinct rank width)
    target_mode: str = "absolute"  # savtpu extension: "increment" trains
                                   # the LSTM decoder head on STEP DELTAS
                                   # (y_t = y_{t-1} + head) instead of
                                   # absolute rows — the r3-proposed
                                   # drift mechanism for the pure-LSTM
                                   # architecture (VERDICT r4 #6); the
                                   # identity carry rides outside the
                                   # network, so zero head output is a
                                   # persistence baseline. "absolute" =
                                   # reference behavior (DNN_tools.py:118).
    input_noise: float = 0.0  # savtpu extension: stddev of Gaussian noise
                              # added to encoder inputs during training
                              # (scaled units) — robustifies the open-loop
                              # block recursion against its own feedback
                              # error at high shard counts
    pred_consensus: bool = True  # savtpu extension: average all owner
                                 # ranks' predictions of each duplicated
                                 # shared DOF before feeding them to the
                                 # solvers. At 2 ranks every shared node
                                 # belongs to both ranks so this only
                                 # denoises; at >2 ranks it restores the
                                 # interface consistency the exchange used
                                 # to enforce (owners otherwise drift
                                 # apart). One index-op per 3000-step
                                 # block — the schedule stays comm-free.
    rollout_windows: int = 1  # savtpu extension: train on this many
                              # CHAINED windows — after the first, the
                              # encoder input is the model's own previous
                              # predictions, exactly the online regime
                              # (post-warm-up history is pure model
                              # feedback, Online_predictor.py:298-301).
                              # 1 = the reference's single-window training.
    modal_dim: int = 0  # savtpu extension: train each rank's surrogate in
                        # the k-dimensional spatial-mode subspace of its
                        # shared trace (PCA of the training portion)
                        # instead of raw DOF space. The measured interface
                        # motion is spatially near-rank-1 (one mode holds
                        # 99.99% of the 96x8x8 trace energy), so a
                        # 486-channel LSTM wastes its capacity and spreads
                        # prediction error over ~485 signal-free
                        # directions, each of which forces the structure
                        # (out-of-band gain ~15x, runs/noise_transfer).
                        # Coefficients are predicted, the block is
                        # reconstructed as mu + coef @ basis — orthogonal
                        # error is zero BY CONSTRUCTION. 0 = off
                        # (reference behavior).
    arch: str = "lstm"  # surrogate architecture: "lstm" (the reference's
                        # encoder-decoder, DNN_tools.py:85-98) |
                        # "expfit" (savtpu extension: two-segment
                        # Prony/matrix-pencil system identification of
                        # the interface motion, models/expfit.py — the
                        # plant is LTI after the 1 s load ramp, so
                        # closed-form pole/amplitude extrapolation
                        # replaces sequence regression entirely; open
                        # loop in time -> zero autoregressive drift;
                        # fits in milliseconds)
                        # | "hybrid" (savtpu extension: expfit base +
                        # LSTM residual — the LTI fit carries the bulk
                        # open-loop in time, the LSTM trains on the
                        # residual mode coefficients and its
                        # autoregressive drift is scaled down by the
                        # residual/signal ratio; the nonlinear-capable
                        # drift-breaker for material.model="neo_hookean".
                        # Requires modal_dim > 0 and the stacked path.)
                        # | "linear"
                        # (savtpu extension: one ridge-regression affine
                        # map flat(n_past window) -> flat(n_future window),
                        # fit in closed form on host — no epochs. The
                        # underlying dynamics are LINEAR elastodynamics,
                        # so on the coarse sampling grid the truth window
                        # map is near-affine; the LSTM's advantage is
                        # representational flexibility it doesn't need
                        # here, and its cost is slow in-band drift
                        # (runs/scale_96/pred_spectrum.json). Pairs
                        # naturally with modal_dim.)
    expfit_order: int = 24  # arch="expfit": matrix-pencil model order
                            # (number of complex poles; conjugate pairs
                            # count twice). 24 covers the beam's resolved
                            # interface modes with margin; the SVD
                            # truncation discards unused ones gracefully.
    expfit_ramp_s: float = 1.0  # arch="expfit": load-ramp end time in
                                # seconds (ops/material.py linear_ramp /
                                # reference commons.py:7-11) — the
                                # two-segment boundary of the signal
                                # model. <= 0 treats the whole trace as
                                # one autonomous segment.
    ridge_lambda: float = 1e-6  # Tikhonov strength for arch="linear",
                                # relative to mean(diag(X^T X)); the fit
                                # is ~insensitive over 1e-4..1e-8.
    linear_rho_max: float = 0.999  # arch="linear" closed-loop stability
                                   # guard: clip eigenvalue magnitudes of
                                   # the square window map to this radius
                                   # (models/linear.py:stabilize_spectrum).
                                   # 0 disables.
    window_phases: int = 1  # savtpu extension: build training windows
                            # from this many coarse-grid phase offsets
                            # (clamped to the stored-trace stride). The
                            # reference trains on the single phase-0
                            # subsample data[::n_s] (DNN_tools.py:291),
                            # leaving (n_s-1)/n_s of the recorded rows
                            # unused; >1 multiplies the window count for
                            # sample-hungry fits (arch="linear").
                            # Scaling constants always come from phase 0
                            # (the reference contract the online stage
                            # cross-checks).
    ensemble: int = 1  # savtpu extension: train this many independently
                       # seeded surrogates per rank (one widened vmapped
                       # stacked pass) and AVERAGE their predictions
                       # online. The fine-mesh closed-loop error is
                       # ~entirely in-band drift (pred_spectrum.json) and
                       # retrain-to-retrain spread is ~1pp, i.e. a large
                       # variance component that seed averaging cancels
                       # ~1/sqrt(E); the systematic component is left
                       # untouched. Scaling constants and modal bases are
                       # data-derived, hence shared across members.
                       # Stacked fast path only (lstm arch); 1 = off.
    pred_anchor: bool = False  # savtpu extension: per-block exchanged
                               # anchoring. At each block start, ONE
                               # exchanged step from the current state
                               # gives the true interface response d1* on
                               # the shared DOFs; the whole predicted
                               # block is de-biased by (d1* - pred[0]).
                               # Targets the in-band closed-loop
                               # autoregressive drift that dominates the
                               # fine-mesh error (runs/noise_transfer +
                               # pred_spectrum: closed-loop error is ~99%
                               # in-band; in-band gain ~3.6x). One psum
                               # per 3000-step block — the same traffic
                               # class as pred_consensus, 3000x below the
                               # per-step exchange. Exact predictions are
                               # a fixed point (delta = 0), unlike
                               # resync_blocks' whole-block release.

    @property
    def epochs(self) -> int:
        if self.num_epochs is not None:
            return self.num_epochs
        return int(math.log(self.lr_min / self.learning_rate, self.decay))

    @property
    def i_cri(self) -> int:
        """Last synchronized step index (Online_predictor.py:63):
        i_cri = n_p * n_s - 1."""
        return self.n_past * self.filter_size - 1

    @property
    def block_size(self) -> int:
        """Refill block length (Online_predictor.py:284): n_f * n_s."""
        return self.n_future * self.filter_size

    def run_tag(self) -> str:
        """Artifact directory tag, mirroring the reference's
        'nB-10-nH-50-Lr-0.0005-filter=150' naming (Model_training.py:28)."""
        return (
            f"nB-{self.batch_size}-nH-{self.hidden_size}"
            f"-Lr-{self.learning_rate}-filter={self.filter_size}"
        )


@dataclass
class Config:
    # mesh file (.vtk legacy ASCII or gmsh .msh 2.2/4.1 ASCII);
    # None -> generated structured beam from beam_cells/beam_extent
    mesh_path: Optional[str] = None
    beam_cells: tuple = (25, 1, 1)    # structured generator resolution
    beam_extent: tuple = (25.0, 1.0, 1.0)
    workdir: str = "Results"          # artifact root (reference: Results/)
    model_dir: str = "Distributed_save"
    # Persistent XLA compilation cache for the stage CLIs. First-dispatch
    # compilation is a real cost at scale (~minutes of the 384^3 stage-4
    # wall, docs/STATUS_r3.md); the ad-hoc scripts always set it, the
    # stage entry points now do too. None/"" disables; an already-configured
    # jax_compilation_cache_dir or JAX_COMPILATION_CACHE_DIR env wins.
    # "auto" resolves to a PER-USER 0700 directory (the cache deserializes
    # compiled executables, so a world-shared /tmp path would let another
    # local user pre-plant cache entries this pipeline then executes).
    compile_cache_dir: Optional[str] = "auto"
    material: MaterialConfig = field(default_factory=MaterialConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    surrogate: SurrogateConfig = field(default_factory=SurrogateConfig)

    # ---------------- (de)serialization ----------------

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def from_json(cls, path: str | Path) -> "Config":
        raw = json.loads(Path(path).read_text())
        return cls(
            **{
                **raw,
                "beam_cells": tuple(raw.get("beam_cells", (25, 1, 1))),
                "beam_extent": tuple(raw.get("beam_extent", (25.0, 1.0, 1.0))),
                "material": MaterialConfig(**raw.get("material", {})),
                "solver": SolverConfig(**raw.get("solver", {})),
                "partition": PartitionConfig(**raw.get("partition", {})),
                "surrogate": SurrogateConfig(**raw.get("surrogate", {})),
            }
        )
