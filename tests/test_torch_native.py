"""The port's own native layout helpers and build configuration against
the JAX package's, on the same seeded inputs."""

import dataclasses

import numpy as np
import pytest

from learnedmetricindex_tpu import config as jax_config
from learnedmetricindex_tpu import native as jax_native
from learnedmetricindex_tpu_torch import config, native


def _layout_case(seed=0, n=20_000, groups=13, tile=64):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, groups, size=n).astype(np.int64)
    labels = rng.integers(0, 5, size=n).astype(np.int32)
    counts = np.bincount(gids, minlength=groups)
    padded = np.maximum(-(-counts // tile) * tile, tile)
    seg = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    return gids, labels, seg, int(padded.sum())


def _call(module, fn):
    gids, labels, seg, total = _layout_case()
    if fn == "fill_slots":
        return module.fill_slots(gids, seg, total, labels=labels)
    if fn == "fill_slots_1based":
        return module.fill_slots_1based(gids, seg, total)
    if fn == "bincount":
        return module.bincount(gids, 13)
    pred = np.random.default_rng(1).integers(0, 10, size=(5000, 3)).astype(np.int64)
    pred[:, 1] %= 4
    return module.ravel_rows(pred, (10, 4, 10))


@pytest.fixture
def route(request, monkeypatch):
    """``library``: both modules call their compiled library; ``numpy``:
    both take their numpy fallback."""
    if request.param == "library":
        if not native.available() or not jax_native.available():
            pytest.skip("no C++ compiler: only the numpy fallback exists here")
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        assert not native.available()
    return request.param


@pytest.mark.parametrize("route", ["library", "numpy"], indirect=True)
@pytest.mark.parametrize("fn", ["fill_slots", "fill_slots_1based", "bincount", "ravel_rows"])
def test_native_matches_the_jax_package(fn, route):
    got, ref = _call(native, fn), _call(jax_native, fn)
    for a, b in zip(got if fn == "fill_slots" else [got], ref if fn == "fill_slots" else [ref]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_library_and_fallback_agree(monkeypatch):
    if not native.available():
        pytest.skip("no C++ compiler: only the numpy fallback exists here")
    fns = ["fill_slots", "fill_slots_1based", "bincount", "ravel_rows"]
    with_lib = [_call(native, fn) for fn in fns]
    monkeypatch.setattr(native, "_load", lambda: None)
    for fn, a in zip(fns, with_lib):
        b = _call(native, fn)
        for x, y in zip(a if fn == "fill_slots" else [a], b if fn == "fill_slots" else [b]):
            np.testing.assert_array_equal(x, y)


CONFIGS = {
    "1-level": (("kmeans", 4, "MLP-4", 0.01, [120]),
                dict(chunk_size=2048, batch_size=1024, seed=2023, class_weights="balanced")),
    "2-level": ((["kmeans"], [3], ["MLP", "MLP-2"], [0.01, 0.05], [10, 10]),
                dict(dtype="bfloat16", update_rule="reference")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_equals_the_jax_package(name):
    args, kwargs = CONFIGS[name]
    ours, theirs = config.BuildConfiguration(*args, **kwargs), jax_config.BuildConfiguration(*args, **kwargs)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.n_levels == theirs.n_levels
    assert [dataclasses.astuple(m) for m in ours.level_configurations] == [
        dataclasses.astuple(m) for m in theirs.level_configurations
    ]
    # a dict saved by either package loads in the other
    assert config.BuildConfiguration.from_dict(theirs.to_dict()).to_dict() == theirs.to_dict()
    assert jax_config.BuildConfiguration.from_dict(ours.to_dict()).to_dict() == ours.to_dict()


BAD = {
    "no levels": (("kmeans", 1, "MLP", 0.01, []), {}),
    "zero categories": (("kmeans", 1, "MLP", 0.01, [0]), {}),
    "mixed scalars and lists": (("kmeans", [1], "MLP", 0.01, [4]), {}),
    "list length": ((["kmeans"], [1, 2, 3], ["MLP"], [0.01], [4, 4]), {}),
    "clustering": (("dbscan", 1, "MLP", 0.01, [4]), {}),
    "model type": (("kmeans", 1, "MLP-99", 0.01, [4]), {}),
    "update rule": (("kmeans", 1, "MLP", 0.01, [4]), {"update_rule": "sgd"}),
    "class weight": (("kmeans", 1, "MLP", 0.01, [4]), {"class_weights": "inverse"}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_config_rejects_what_the_jax_package_rejects(case):
    """Every argument the JAX package refuses (with an assertion) the port
    refuses with ValueError."""
    args, kwargs = BAD[case]
    with pytest.raises(AssertionError):
        jax_config.BuildConfiguration(*args, **kwargs)
    with pytest.raises(ValueError):
        config.BuildConfiguration(*args, **kwargs)
