"""The port's sharded-tier stress cycle (imatch_tpu_torch/scripts/
stress_sharded_store.py) at tests/test_stress_sharded.py's size on the CPU.

``ivf-sharded`` over 8 logical shards of the CPU, 8192 x 64 rows: bulk
add, three mutation rounds (appends, deletes, updates), a snapshot and a
restore with a journal replay, compaction and a second restore, each
checkpoint equal to a numpy exact-cosine oracle at a full probe. The
script runs in a subprocess, as the JAX test runs its own, with exit
status 0 and ``"ok": true`` in its JSON summary.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,d", [(8192, 64)])
def test_stress_cycle_scaled(n, d):
    r = subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch.scripts.stress_sharded_store", str(n), str(d), "--device", "cpu"],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
        timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    passes = [line for line in lines if line.startswith("PASS ")]
    assert len(passes) == 7 and not any(line.startswith("FAIL") for line in lines)
    summary = json.loads(lines[-1])
    assert summary["ok"] is True and summary["devices"] == 8 and summary["n"] == n
    assert summary["stats"]["engine"] == "ivf-sharded"
