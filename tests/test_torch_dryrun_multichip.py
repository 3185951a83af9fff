"""The port's ``dryrun_multichip`` on logical ``cpu`` shards: the
counterpart of tests/test_parallel.py:133 (``__graft_entry__
.dryrun_multichip(8)``). Every parallel path on one grid: the DP + TP
train step, the sharded search, the sharded stores with their patches and
a device-resident add, ivf-sharded at full probe, the W8A8 embedder over
the data axis, ring attention and GPipe. At 8 shards the grid is (4, 2);
at 3 it is (3, 1), where GPipe has no model axis to run over.
"""

import pytest

from imatch_tpu_torch.scripts.dryrun_multichip import dryrun_multichip, main


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_cpu_shards(n):
    out = dryrun_multichip(n, "cpu")
    assert out["grid"] == ({"data": 4, "model": 2} if n == 8 else {"data": 3, "model": 1})
    assert out["patched_mutations"] >= 2
    assert ("gpipe_max_abs_err" in out) == (n == 8)


def test_dryrun_multichip_cli(capsys):
    assert main(["--devices", "4", "--device", "cpu"]) == 0
    assert "dryrun_multichip ok" in capsys.readouterr().out


def test_dryrun_multichip_without_device_raises_on_a_cpu_machine():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(8)
