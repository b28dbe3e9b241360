"""``scripts/gen_synth_corpus.py``: the corpus ``chip_smoke.py`` trains on
is made from its seed alone, the same in every process."""

import os
import subprocess
import sys

import numpy as np
import pytest

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "gen_synth_corpus.py")


@pytest.mark.parametrize("spatial", [False, True])
def test_corpus_is_reproducible_across_processes(tmp_path, spatial):
    outs = []
    for i, hash_seed in enumerate(("1", "2")):
        out = tmp_path / f"c{i}"
        cmd = [sys.executable, SCRIPT, "--out", str(out), "--n_train", "3",
               "--n_val", "1", "--n_test", "0", "--n_styled", "2"]
        env = dict(os.environ, PYTHONHASHSEED=hash_seed)
        subprocess.run(cmd + (["--spatial"] if spatial else []), env=env,
                       check=True, capture_output=True, timeout=120)
        outs.append(out)
    a, b = (np.load(o / "features.npz") for o in outs)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    assert (outs[0] / "train.txt").read_text() == \
        (outs[1] / "train.txt").read_text()
