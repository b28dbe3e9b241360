"""The NumPy checkpoint format (``checkpoint/npz.py``) and the trainer
checkpoints built on it: round trips, exact optax types, structure checks,
kill-safe replacement and placement with the template's sharding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from icee_tpu.checkpoint import npz


def _tree():
    return {
        "w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "half": jnp.asarray([1.5, -2.25], jnp.bfloat16),
        "ids": np.array([3, 1], np.int32),
        "flag": np.array(True),
        "seq": [np.float32(1.0), (np.int64(7), np.zeros(2, np.float32))],
        "none": None,
    }


def test_template_round_trip_is_exact(tmp_path):
    tree = _tree()
    path = npz.save_tree(str(tmp_path / "c"), tree)
    got = npz.load_tree(path, tree)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_raw_restore_is_nested_dicts_and_lists(tmp_path):
    path = npz.save_tree(str(tmp_path / "c"), _tree())
    raw = npz.load_tree(path)
    assert set(raw) == {"w", "half", "ids", "flag", "seq"}
    assert raw["half"].dtype == jnp.bfloat16
    assert isinstance(raw["seq"], list) and isinstance(raw["seq"][1], list)
    assert int(raw["seq"][1][0]) == 7


def test_optax_state_types_come_back(tmp_path):
    params = {"a": jnp.ones((3,)), "b": {"c": jnp.zeros((2, 2))}}
    tx = optax.adam(1e-3)
    state = tx.init(params)
    _, state = tx.update(jax.tree_util.tree_map(jnp.ones_like, params),
                         state, params)
    path = npz.save_tree(str(tmp_path / "o"), state)
    got = npz.load_tree(path, tx.init(params))
    assert type(got[0]) is type(state[0])
    assert int(got[0].count) == 1
    np.testing.assert_allclose(got[0].mu["a"], state[0].mu["a"])


def test_structure_mismatch_is_refused(tmp_path):
    path = npz.save_tree(str(tmp_path / "c"), {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="does not match"):
        npz.load_tree(path, {"b": np.zeros(2)})


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        npz.load_tree(str(tmp_path / "nothing"))


def test_old_survivor_is_read_and_healed(tmp_path):
    path = npz.save_tree(str(tmp_path / "c"), {"row": np.array(1)})
    os.rename(path, path + ".old")        # killed between the two renames
    assert npz.live_path(path) == path + ".old"
    assert int(npz.load_tree(path)["row"]) == 1
    npz.save_tree(path, {"row": np.array(2)})
    assert not os.path.exists(path + ".old")
    assert int(npz.load_tree(path)["row"]) == 2


def test_unfinished_save_is_invisible(tmp_path):
    path = str(tmp_path / "c")
    os.makedirs(path)                      # no tree.json: never completed
    assert npz.live_path(path) is None
    npz.remove(path)
    assert not os.path.exists(path)


def test_metadata_round_trip(tmp_path):
    path = npz.save_tree(str(tmp_path / "c"), {"a": np.zeros(1)},
                         {"epoch": 3, "mode": "HAP"})
    assert npz.metadata(path) == {"epoch": 3, "mode": "HAP"}


def test_trainer_checkpoint_names_and_metadata(tmp_path):
    from icee_tpu.checkpoint.ckpt import (CheckpointState, load_params,
                                          save_checkpoint)

    state = CheckpointState(
        epoch=4, epochs_since_improvement={"factual": 1},
        best_bleu4={"factual": 0.5},
        params={"decoder": {"w": np.ones(2, np.float32)}, "head": {}},
        opt_states={})
    path = save_checkpoint(str(tmp_path), "toy", "HAP", state, True)
    assert os.path.basename(path) == "HAP_checkpoint_toy"
    assert os.path.isdir(tmp_path / "HAP_BEST_checkpoint_toy")
    assert npz.metadata(path) == {"mode": "HAP", "data_name": "toy",
                                  "epoch": 4}
    np.testing.assert_array_equal(load_params(path)["decoder"]["w"],
                                  np.ones(2))


def test_restore_places_leaves_with_the_template_sharding(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icee_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((4, 2))
    sharding = NamedSharding(mesh, P("data"))
    x = jax.device_put(jnp.arange(16.0).reshape(8, 2), sharding)
    path = npz.save_tree(str(tmp_path / "s"), {"x": x})
    got = npz.load_tree(path, {"x": x})["x"]
    assert got.sharding == sharding
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x))
