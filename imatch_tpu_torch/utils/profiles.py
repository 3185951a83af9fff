"""Deployment profiles: one knob that sets a group of ``IMATCH_*`` variables.

The port's copy of ``imatch_tpu/utils/profiles.py`` (framework-free, kept
here so the port imports nothing of the JAX package;
tests/test_torch_profiles.py holds ``PROFILES`` and ``apply_profile`` to
the original). The launcher (``python -m imatch_tpu_torch``) applies it
before it imports the serving stack, as run.py does.

``IMATCH_PROFILE``:

- ``latency``: interactive search-first serving: decode segments of 2,
  the ``auto`` index engine, warmup on.
- ``throughput``: bulk ingest and back-fill: monolithic decode, the W8A8
  image tower, int8 Moondream weights with the W8A8 prefill, back-fill
  and yes/no chunks of 128, device-resident ingest. Request coalescing is
  not in it (the JAX package measured it losing to pipelining; it stays
  an explicit opt-in).
- ``capacity``: the largest corpus a device: the ``auto`` engine (sharded
  over every visible card, escalated to tilemax-host by the device
  budget), int8 phase-1 scoring with the fp32 rescore, int8 Moondream
  weights, KV cache and W8A8 prefill, the W8A8 image tower.

The profiles' values and the reasons for them are the JAX package's
(its docs/DESIGN.md); their speed on the card is not measured here.
Explicit variables always win: a profile fills in unset keys only, so
``IMATCH_PROFILE=latency IMATCH_MD_SEG=4`` runs segments of 4.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("imatch.profiles")

PROFILES: dict[str, dict[str, str]] = {
    "latency": {
        "IMATCH_MD_SEG": "2",
        "IMATCH_INDEX_ENGINE": "auto",
        "IMATCH_WARMUP": "1",
    },
    "throughput": {
        "IMATCH_MD_SEG": "0",
        "IMATCH_INDEX_ENGINE": "auto",
        "IMATCH_EMBED_QUANT": "int8",
        "IMATCH_MD_QUANT": "int8",
        "IMATCH_MD_ACT": "int8",
        "IMATCH_VLM_VQA_CHUNK": "128",
        "IMATCH_BACKFILL_BATCH": "128",
        "IMATCH_DEVICE_INGEST": "1",
    },
    "capacity": {
        "IMATCH_INDEX_ENGINE": "auto",
        "IMATCH_SCORE_DTYPE": "int8",
        "IMATCH_MD_QUANT": "int8",
        "IMATCH_MD_CACHE": "int8",
        "IMATCH_MD_ACT": "int8",
        "IMATCH_EMBED_QUANT": "int8",
    },
}

_QUANT_KEYS = (
    "IMATCH_EMBED_QUANT",
    "IMATCH_MD_QUANT",
    "IMATCH_MD_ACT",
    "IMATCH_MD_CACHE",
    "IMATCH_SCORE_DTYPE",
)


def apply_profile(env: os._Environ | dict | None = None) -> dict[str, str]:
    """Fill in the variables of ``IMATCH_PROFILE``, if set, in ``env``
    (``os.environ`` by default). Returns the pairs applied (those not set
    already). An unknown profile name raises ValueError, so a typo fails
    at start instead of serving with the defaults."""
    if env is None:
        env = os.environ
    name = env.get("IMATCH_PROFILE", "").strip().lower()
    if not name:
        return {}
    if name not in PROFILES:
        raise ValueError(f"IMATCH_PROFILE={name!r}: unknown profile (choose from {sorted(PROFILES)})")
    applied = {}
    for key, value in PROFILES[name].items():
        if key not in env:
            env[key] = value
            applied[key] = value
    # a profile's IMATCH_MD_ACT=int8 must not fail the runtime when the
    # user set IMATCH_MD_QUANT to something else (explicit values win);
    # a user-set IMATCH_MD_ACT still fails loudly in MoondreamTorch
    if applied.get("IMATCH_MD_ACT") == "int8" and env.get("IMATCH_MD_QUANT") != "int8":
        del env["IMATCH_MD_ACT"]
        del applied["IMATCH_MD_ACT"]
        log.info(
            "profile %s: dropping IMATCH_MD_ACT=int8 (explicit IMATCH_MD_QUANT=%r is not int8)",
            name,
            env.get("IMATCH_MD_QUANT"),
        )
    # the int8 tiers' quality gates need real checkpoints (WEIGHTS.md
    # section 5): a profile that turns them on says so until
    # IMATCH_QUANT_BLESSED=1 confirms the gates passed
    quant_on = sorted(k for k in _QUANT_KEYS if applied.get(k) == "int8")
    if quant_on and env.get("IMATCH_QUANT_BLESSED", "") not in ("1", "true", "yes"):
        log.warning(
            "profile %s enables int8/W8A8 tiers (%s) whose quality gates have NOT been run "
            "against real checkpoints. Run the WEIGHTS.md section 5 gates once real weights are "
            "installed, then set IMATCH_QUANT_BLESSED=1 to confirm, or override the individual "
            "flags to opt out.",
            name,
            ", ".join(quant_on),
        )
    if applied:
        log.info("profile %s: %s", name, " ".join(f"{k}={v}" for k, v in sorted(applied.items())))
    return applied
