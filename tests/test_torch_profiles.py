"""The port's utils/profiles.py held to imatch_tpu/utils/profiles.py.

``PROFILES`` is equal, and ``apply_profile`` makes the same changes to
the same environment and returns the same pairs for every profile, with
and without explicit values (which win), drops a profile's
IMATCH_MD_ACT=int8 beside a non-int8 IMATCH_MD_QUANT, warns about the
unblessed int8 tiers in the same cases, and raises ValueError on an
unknown name. The launcher applies the profile before anything else.
"""

import logging
import os
import subprocess
import sys

import pytest

from imatch_tpu.utils import profiles as jax_profiles
from imatch_tpu_torch.utils import profiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profiles_are_equal():
    assert profiles.PROFILES == jax_profiles.PROFILES


ENVS = [
    {},
    {"IMATCH_PROFILE": "latency"},
    {"IMATCH_PROFILE": " Throughput "},
    {"IMATCH_PROFILE": "capacity"},
    {"IMATCH_PROFILE": "capacity", "IMATCH_QUANT_BLESSED": "1"},
    {"IMATCH_PROFILE": "latency", "IMATCH_MD_SEG": "4", "IMATCH_INDEX_ENGINE": "ivf"},
    {"IMATCH_PROFILE": "throughput", "IMATCH_MD_QUANT": "none"},
    {"IMATCH_PROFILE": "capacity", "IMATCH_MD_QUANT": "int8", "IMATCH_SCORE_DTYPE": "bf16"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_apply_profile_matches(env, caplog):
    got = {}
    for name, mod in (("jax", jax_profiles), ("torch", profiles)):
        e = dict(env)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="imatch.profiles"):
            applied = mod.apply_profile(e)
        levels = sorted(r.levelname for r in caplog.records)
        got[name] = (applied, e, levels)
    assert got["torch"] == got["jax"]


def test_unknown_profile_raises():
    for mod in (jax_profiles, profiles):
        with pytest.raises(ValueError, match="unknown profile"):
            mod.apply_profile({"IMATCH_PROFILE": "fastest"})


def test_launcher_applies_the_profile_first(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, IMATCH_PROFILE="fastest", IMATCH_ROOT=str(tmp_path), PORT="0")
    proc = subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch"],
        capture_output=True,
        text=True,
        env=env,
        cwd=str(tmp_path),
        timeout=300,
    )
    assert proc.returncode != 0
    assert "IMATCH_PROFILE='fastest': unknown profile" in proc.stderr
