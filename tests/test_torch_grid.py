"""The port's stage-3 hyper-parameter grid (``model_training.run_grid``
and the CLI's ``--grid-batch-sizes``, ``--grid-lrs``, ``--grid-hidden``)
against savtpu's, on the CPU: the same (n_B, eta0, n_H) combinations in
the same order, each trained into its own run-tag directory, named as
savtpu names them (savtpu's ``run_grid`` is run with its per-combination
``run`` recorded instead of trained), each with its ``model.npz`` and a
finite training loss; flags left out keep the config's value."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _cfg(C, root):
    cfg = C()
    cfg.workdir = str(root / "Results")
    cfg.model_dir = str(root / "Distributed_save")
    cfg.beam_cells = (6, 1, 1)
    cfg.beam_extent = (6.0, 1.0, 1.0)
    cfg.partition.n_parts = 2
    cfg.solver.num_steps = 200
    s = cfg.surrogate
    s.n_past, s.n_future, s.filter_size = 4, 4, 5
    s.batch_size, s.hidden_size, s.num_epochs = 2, 8, 2
    return cfg


@pytest.fixture(scope="module")
def stages12(tmp_path_factory):
    from savtpu_torch.config import Config
    from savtpu_torch.pipeline import data_prepare, shared_extraction

    root = tmp_path_factory.mktemp("grid")
    cfg = _cfg(Config, root)
    data_prepare.run(cfg, verbose=False, device="cpu")
    shared_extraction.run(cfg)
    return root


def _savtpu_tags(monkeypatch, tmp_path, *grid):
    from savtpu.config import Config as JConfig
    from savtpu.pipeline import model_training as j_mt

    seen = []
    monkeypatch.setattr(j_mt, "run", lambda c, verbose=True: seen.append(
        c.surrogate.run_tag()))
    j_mt.run_grid(_cfg(JConfig, tmp_path), *grid, verbose=False)
    return seen


def _trained(root, cfg_like_tags, n_parts=2):
    out = {}
    for tag in cfg_like_tags:
        for r in range(n_parts):
            d = root / "Distributed_save" / f"Rank-{r}" / tag
            assert (d / "model.npz").exists(), d
        out[tag] = d
    return out


def test_run_grid_directories_match_savtpus(stages12, monkeypatch,
                                            tmp_path):
    from savtpu_torch.config import Config
    from savtpu_torch.pipeline import model_training

    grid = ([2, 3], [1e-3, 5e-4], [8])
    want = _savtpu_tags(monkeypatch, tmp_path, *grid)
    cfg = _cfg(Config, stages12)
    res = model_training.run_grid(cfg, *grid, verbose=False, device="cpu")
    assert list(res) == [(nb, lr, nh) for nb in grid[0] for lr in grid[1]
                         for nh in grid[2]]
    got = []
    for (nb, lr, nh), per_rank in res.items():
        c = _cfg(Config, stages12)
        c.surrogate.batch_size, c.surrogate.learning_rate = nb, lr
        c.surrogate.hidden_size = nh
        got.append(c.surrogate.run_tag())
        assert set(per_rank) == {0, 1}
        for r, (_, hist) in per_rank.items():
            assert np.isfinite(hist["train_loss"][-1])
    assert got == want and len(set(got)) == 4
    _trained(stages12, got)
    # the caller's config is untouched
    assert (cfg.surrogate.batch_size, cfg.surrogate.learning_rate) == (
        2, _cfg(Config, stages12).surrogate.learning_rate)


def test_cli_grid_flags(stages12, monkeypatch, tmp_path):
    from savtpu_torch.config import Config
    from savtpu_torch.pipeline import model_training

    cfg = _cfg(Config, stages12)
    path = tmp_path / "cfg.json"
    cfg.to_json(str(path))
    want = _savtpu_tags(monkeypatch, tmp_path, [cfg.surrogate.batch_size],
                        [0.002, 0.004], [cfg.surrogate.hidden_size])
    model_training.main(["--config", str(path), "--grid-lrs", "0.002",
                         "0.004", "--epochs", "1", "--device", "cpu"])
    dirs = _trained(stages12, want)
    for tag, d in dirs.items():
        meta = json.loads(next(d.glob("*.json")).read_text())
        assert meta
    # without a --grid-* flag the CLI trains the config's one combination
    seen = []
    monkeypatch.setattr(model_training, "run_grid",
                        lambda *a, **k: seen.append(a))
    monkeypatch.setattr(model_training, "run",
                        lambda c, device=None: seen.append("run"))
    model_training.main(["--config", str(path), "--device", "cpu"])
    assert seen == ["run"]
