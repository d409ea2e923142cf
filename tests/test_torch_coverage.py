"""The port's coverage of savtpu's public surface, read from the sources
with ``ast`` (neither package is imported).

Every public top-level function and class of ``savtpu/**/*.py`` and every
public method of such a class, by its dotted name under the package (a
module's ``__init__`` by the package's name), either has a definition of
the same dotted name in ``savtpu_torch/`` or is a key of ``UNMATCHED``.
There a name maps to the port's counterpart under another name (a
rename into PyTorch's idiom; the counterpart must exist) or, with
``why(...)``, to the reason savtpu's JAX or TPU plumbing has no
counterpart. The map holds only names that need it, and no reason says
that something is left to port.
"""

import ast
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def why(reason: str) -> tuple:
    """A reason, where the port has no counterpart by design."""
    return ("why", reason)


UNMATCHED = {
    # renames: the port's counterpart
    "models.linear.linear_predict": "models.linear.StackedLinear.predict",
    "models.lstm.init_lstm_cell": "models.lstm.StackedSeq2Seq",
    "models.lstm.init_seq2seq": "models.lstm.StackedSeq2Seq",
    "models.lstm.encoder_forward": "models.lstm.StackedSeq2Seq.encode",
    "models.lstm.decoder_step": "models.lstm.StackedSeq2Seq.predict",
    "models.lstm.seq2seq_predict": "models.lstm.StackedSeq2Seq.predict",
    "models.lstm.seq2seq_train_decode":
        "models.lstm.StackedSeq2Seq.train_decode",
    "models.training.TrainState": "models.training.rank_epochs",
    "models.training.TrainState.loss_fn": "models.training.mse",
    "models.training.evaluate": "models.training.rank_epochs",
    "ops.pallas_step.batched_fint_matvec":
        "ops.dense_step.batched_fint_matvec",
    "ops.pallas_step.pallas_scan_comm_free": "ops.dense_step.scan_comm_free",
    "ops.pallas_banded.pallas_scan_comm_free_banded":
        "ops.banded_scan.scan_comm_free_banded",
    "ops.pallas_banded.pallas_online_chunk": "ops.online_banded.online_chunk",
    "ops.pallas_step.scan_vmem_bytes": "ops.dense_step.scan_plan",
    "ops.pallas_banded.banded_scan_vmem_bytes": "ops.band_plan.band_plan",
    "ops.pallas_banded.online_scan_vmem_bytes": "ops.band_plan.band_plan",
    "ops.precision.with_fem_precision": "utils.full_precision_products",
    "pipeline.online_predictor.make_block_group_runner":
        "pipeline.online_predictor.run",
    # JAX and TPU plumbing: the reason
    "enable_x64": why("JAX's float64 switch; torch has float64 without "
                      "one"),
    "models.lstm.num_params": why("a JAX pytree's leaf count; the port's "
                                  "models are nn.Modules"),
    "ops.pallas_step.pad_dl": why("pads DL to the TPU's 256-lane tiles; "
                                  "the CUDA kernels take DL as it is"),
    "parallel.stencil.face_maps": why(
        "slice-writes that avoid gathers, slow on a TPU; the port's "
        "gather and scatter give the same bits (ROADMAP, known and "
        "accepted)"),
    "pipeline.common.StageContext.join_warm": why(
        "joins the thread that warms XLA's compiles; nothing compiles "
        "ahead in the port"),
    "pipeline.common.resolve_cache_dir": why(
        "the JAX compilation cache's directory; the port's kernels build "
        "into savtpu_torch/_build/"),
    "solvers.explicit.run_explicit_jit": why(
        "run_explicit under jax.jit; the port's run_explicit runs eager "
        "on the operator's device"),
}


def _public(pkg: str) -> dict:
    """{dotted name: "file:line"} of a package's public top-level
    functions and classes and their public methods (the port's ignored
    ``_build/`` left out)."""
    base = ROOT / pkg
    out = {}
    for f in sorted(base.rglob("*.py")):
        rel = f.relative_to(base)
        if rel.parts[0] == "_build":
            continue
        parts = rel.with_suffix("").parts
        mod = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        for node in ast.parse(f.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            name = f"{mod}.{node.name}" if mod else node.name
            out[name] = f"{f.relative_to(ROOT)}:{node.lineno}"
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and not m.name.startswith("_")):
                        out[f"{name}.{m.name}"] = (
                            f"{f.relative_to(ROOT)}:{m.lineno}")
    return out


def test_every_public_name_of_savtpu_has_a_counterpart_or_a_reason():
    t0 = time.perf_counter()
    jax_side, port = _public("savtpu"), _public("savtpu_torch")
    assert time.perf_counter() - t0 < 1.0
    assert len(jax_side) > 200 and len(port) > len(jax_side)
    missing = {k: v for k, v in jax_side.items()
               if k not in port and k not in UNMATCHED}
    assert not missing, f"savtpu names with no counterpart: {missing}"


def test_the_map_does_not_rot():
    jax_side, port = _public("savtpu"), _public("savtpu_torch")
    for name, to in UNMATCHED.items():
        assert name in jax_side, f"{name} is not a public name of savtpu"
        assert name not in port, f"{name} has its own counterpart now"
        if isinstance(to, tuple):
            assert to[0] == "why" and len(to[1].split()) > 3, name
            assert "not ported" not in to[1].lower(), name
            assert "to port" not in to[1].lower(), name
        else:
            assert to in port, f"{name} -> {to}: no such name in the port"


def test_names_that_the_port_gained_last_are_there():
    """The functions ROADMAP's last port queue named, by savtpu's dotted
    names (held to savtpu in tests/test_torch_public_api.py)."""
    port = _public("savtpu_torch")
    for name in ("parallel.sharded.ShardedProblem.globalize",
                 "native.native_partition", "native.native_first_touch",
                 "native.native_refine",
                 "ops.assembly.FIntOperator.dense_matrix",
                 "pipeline.online_predictor.owner_counts",
                 "ops.element.element_mkf", "ops.shape.jacobian",
                 "ops.shape.isoparametric_map"):
        assert name in port, name
