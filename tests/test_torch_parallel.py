"""The port's model axis against the JAX package, on 8 logical CPU devices.

The port's grid is a device list in which ``cpu`` repeats (the
counterpart of the JAX suite's 8 virtual host devices); the JAX side runs
on those virtual devices. Weights are JAX's ``init_params`` /
``init_md_params`` trees carried across through the bridges; inputs come
from numpy seeds. JAX's sharded steps are compiled once, in module-scoped
fixtures. Ports of tests/test_parallel.py's bars:

- ``mesh_shape_for`` and ``make_mesh``: shapes and errors (:25-27).
- The spec trees cover exactly JAX's leaves, equal to JAX's specs (:30-38);
  each model shard's slices equal the JAX spec's slice of the same tree.
- A DP+TP step at mp 1, 2 and 4: two steps finite, the loss falling on a
  repeated batch (:46-69; the port has no XLA:CPU rendezvous, so mp = 4
  runs too).
- The (4, 2) loss equals the one-device loss and JAX's (4, 2) loss within
  rtol 2e-5, from ``jax.random.key(7)`` carried across (:72-100); after
  one step the parameters equal JAX's within test_torch_train.py's bars
  (atol 1e-6; the moments within 1e-4 of each leaf's largest magnitude).
  The step repeats bit for bit.
- A (4, 2) checkpoint restores and steps (:189-215): in the port at (4, 2)
  and on one device (the continued loss within rtol 1e-6), and across
  packages both ways (the restored leaves equal the file's; the next step
  within rtol 2e-5 of the other package's).
- ``train_clip --mp 2`` on four logical CPU devices, with a resume at
  ``--mp 4``.
- The Moondream prefill under TP equals JAX's TP prefill and the port's
  one-device prefill within rtol 5e-4, atol 5e-5 (:399-437); its cache is
  split by heads, and greedy decode from it gives the one-device tokens.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.models.moondream import TINY_MD as JAX_TINY_MD
from imatch_tpu.models.moondream import encode_image_features as jax_encode
from imatch_tpu.models.moondream import init_md_params
from imatch_tpu.models.moondream import prefill as jax_prefill
from imatch_tpu.parallel import checkpoint as jax_ckpt
from imatch_tpu.parallel import mesh as jax_mesh
from imatch_tpu.parallel import sharding as jax_sharding
from imatch_tpu.parallel import train as jax_train
from imatch_tpu_torch.models.clip.bridge import named_to_numpy, params_from_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.moondream.bridge import md_params_from_numpy
from imatch_tpu_torch.models.moondream.configs import TINY_MD
from imatch_tpu_torch.models.moondream.generate import greedy_generate, prefill
from imatch_tpu_torch.models.moondream.model import encode_image_features
from imatch_tpu_torch.parallel import (
    clip_param_specs,
    data_spec,
    init_train_state,
    make_mesh,
    make_train_step,
    md_param_specs,
    mesh_shape_for,
    replicated,
)
from imatch_tpu_torch.parallel.checkpoint import restore_checkpoint, save_checkpoint
from imatch_tpu_torch.parallel.sharding import gather_named, shard_model, split_rules
from imatch_tpu_torch.parallel.train import make_optimizer
from imatch_tpu_torch.scripts import train_clip

JTINY = jax_configs.TINY
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def eight_devices():
    """JAX's side runs on the 8 virtual host devices the root conftest.py
    asks for."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tok = rng.integers(0, TINY.text.eos_token_id, (b, TINY.text.max_positions)).astype(np.int32)
    for i, n in enumerate(rng.integers(3, TINY.text.max_positions, b)):
        tok[i, n:] = TINY.text.eos_token_id
    return px, tok


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _leaf_close(want, got, rel, atol):
    """Per leaf: max |got - want| <= rel * max |want| + atol."""
    got = _flat(got)
    for path, a in _flat(want).items():
        a = np.asarray(a, np.float64)
        err = np.abs(a - np.asarray(got[path], np.float64)).max(initial=0.0)
        assert err <= rel * np.abs(a).max(initial=0.0) + atol, (path, err)


def _tree_of(model, named=None):
    """A (sharded) model's parameters, or tensors keyed by its names, as
    the full JAX-layout numpy tree."""
    named = dict(model.named_parameters()) if named is None else named
    return named_to_numpy(gather_named(named, model), model.cfg)


# -- the grid ------------------------------------------------------------------


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_mesh_shape(mp):
    grid = make_mesh(model_parallel=mp, devices=CPU8)
    jmesh = jax_mesh.make_mesh(model_parallel=mp)
    assert grid.shape == {"data": jmesh.shape["data"], "model": jmesh.shape["model"]}
    assert grid.shape == {"data": 8 // mp, "model": mp}
    assert mesh_shape_for(8, mp) == jax_mesh.mesh_shape_for(8, mp)
    assert len(grid.row(0)) == mp and grid.row(8 // mp - 1) == tuple(grid[-mp:])
    assert grid.device(8 // mp - 1, mp - 1) == torch.device("cpu")


def test_mesh_errors():
    for n, mp in ((8, 3), (6, 4), (1, 2)):
        with pytest.raises(ValueError):
            mesh_shape_for(n, mp)
        with pytest.raises(ValueError):
            jax_mesh.mesh_shape_for(n, mp)
    with pytest.raises(ValueError):
        make_mesh(3, CPU8)
    with pytest.raises(ValueError):
        make_mesh(1, [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)
        with pytest.raises(RuntimeError):
            make_mesh(1, ["cpu", "cuda:0"])
    # the store's form: a device list is the data axis
    assert make_mesh(["cpu"] * 4) == make_mesh(1, ["cpu"] * 4) == (torch.device("cpu"),) * 4
    assert make_mesh(["cpu"] * 4).shape == {"data": 4, "model": 1}


def test_model_one_grid_serves_the_sharded_store():
    from imatch_tpu_torch.index.store import VectorStore

    rng = np.random.default_rng(3)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = [f"r{i}" for i in range(300)]
    got = []
    for kw in ({"engine": "tilemax"}, {"engine": "sharded", "mesh": make_mesh(1, ["cpu"] * 4)}):
        s = VectorStore(dim=16, device="cpu", score_dtype="float32", **kw)
        s.add(ids=ids, embeddings=emb)
        got.append(s.query(emb[:5], n_results=10))
    assert got[0]["ids"] == got[1]["ids"]


# -- the specs -------------------------------------------------------------------


def test_spec_trees_cover_jax_leaves():
    for port, jax_specs, tree in (
        (clip_param_specs(), jax_sharding.clip_param_specs(), init_params(jax.random.key(0), JTINY)),
        (md_param_specs(), jax_sharding.md_param_specs(), init_md_params(jax.random.key(0), JAX_TINY_MD)),
    ):
        flat, jflat = _flat(port), _flat(jax_specs)
        assert set(flat) == set(jflat) == set(_flat(tree))
        for path, spec in flat.items():
            assert tuple(spec) == tuple(jflat[path]), path
            assert len(spec) in (0, np.ndim(_flat(tree)[path])), path
    assert tuple(data_spec(3)) == tuple(jax_sharding.data_spec(3)) == ("data", None, None)
    assert tuple(replicated()) == tuple(jax_sharding.replicated()) == ()


def _spec_slice(tree, specs, m, shards):
    """Shard m's slice of a numpy tree by JAX's specs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _spec_slice(v, specs[k], m, shards)
            continue
        spec = tuple(specs[k])
        v = np.asarray(v)
        if "model" in spec:
            v = np.split(v, shards, axis=spec.index("model"))[m]
        out[k] = v
    return out


@pytest.mark.parametrize("family", ["clip", "md", "md-unpacked"])
@pytest.mark.parametrize("mp", [2, 4])
def test_slices_follow_the_jax_specs(family, mp):
    """``shard_model``'s slices, bridged from the full tree, equal the
    modules bridged from JAX's spec slices of the same tree; peers hold
    split leaves only; gathering them gives the full model back."""
    key = jax.random.key(1)
    if family == "clip":
        tree = jax.tree.map(np.asarray, init_params(key, JTINY))
        specs = jax_sharding.clip_param_specs()

        def build(t, shards=1):
            return params_from_numpy(t, TINY, shards=shards)

    else:
        tree = jax.tree.map(np.asarray, init_md_params(key, JAX_TINY_MD))
        specs = jax_sharding.md_param_specs()
        packed = family == "md"

        def build(t, shards=1):
            return md_params_from_numpy(t, TINY_MD, packed=packed, shards=shards)

    full = build(tree)
    sharded = shard_model(full, ["cpu"] * mp)
    named = dict(sharded.named_parameters())
    rules = split_rules(sharded)
    for m in range(mp):
        piece = build(_spec_slice(tree, specs, m, mp), mp)
        for n, p in piece.named_parameters():
            name = n if m == 0 else f"peers.{m - 1}.{n}"
            if m and n not in rules:
                assert name not in named, name  # replicated: shard 0 only
                continue
            assert torch.equal(named[name], p), name
    assert sum(p.numel() for p in sharded.parameters()) == sum(p.numel() for p in full.parameters())
    back = gather_named(named, sharded)
    assert all(torch.equal(back[n], p) for n, p in full.named_parameters())


# -- the train step ---------------------------------------------------------------


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_train_step_sharded(mp):
    grid = make_mesh(model_parallel=mp, devices=CPU8)
    state, tx = init_train_state(0, TINY, mesh=grid)
    assert len(state.params.peers) == mp - 1
    step = make_train_step(TINY, tx, mesh=grid)
    px, tok = _batch(0, 2 * grid.shape["data"])
    state, loss = step(state, px, tok)
    state, loss2 = step(state, px, tok)
    assert torch.isfinite(loss) and torch.isfinite(loss2)
    assert float(loss2) < float(loss)  # a repeated batch's loss falls
    assert state.step == 2 and int(state.opt_state.count) == 2


def test_train_step_refuses_another_model_axis():
    """A state sharded at mp = 2 on a grid of model 1 names the mismatch
    rather than placing the data shards' copies on the wrong devices."""
    state, tx = init_train_state(0, TINY, mesh=make_mesh(model_parallel=2, devices=CPU8[:4]))
    step = make_train_step(TINY, tx, mesh=make_mesh(model_parallel=1, devices=CPU8[:4]))
    with pytest.raises(ValueError, match="model axis 1 != the state's 2 model shards"):
        step(state, *_batch(0, 4))


@pytest.fixture(scope="module")
def tree7():
    return jax.tree.map(np.asarray, init_params(jax.random.key(7), JTINY))


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's (4, 2) step, compiled once, and its state after one step from
    ``jax.random.key(7)`` on batch 1 (loss, params, moments, and the state)."""
    mesh = jax_mesh.make_mesh(model_parallel=2)
    tx = jax_train.make_optimizer()
    step = jax_train.make_train_step(JTINY, tx, mesh=mesh)
    state, _ = jax_train.init_train_state(jax.random.key(7), JTINY, tx, mesh=mesh)
    state, loss = step(state, *map(jnp.asarray, _batch(1, 8)))
    adam = state.opt_state[1][0]
    return {
        "mesh": mesh,
        "tx": tx,
        "step": step,
        "state": state,
        "loss": float(loss),
        "params": jax.tree.map(np.asarray, state.params),
        "mu": jax.tree.map(np.asarray, adam.mu),
        "nu": jax.tree.map(np.asarray, adam.nu),
    }


def test_tp_matches_single_device_and_jax(tree7, jax_tp):
    px, tok = _batch(1, 8)
    tx = make_optimizer()
    one, _ = init_train_state(tree7, TINY, tx, device="cpu")
    one, loss1 = make_train_step(TINY, tx)(one, px, tok)
    grid = make_mesh(model_parallel=2, devices=CPU8)
    runs = []
    for _ in range(2):
        st, _ = init_train_state(tree7, TINY, tx, mesh=grid)
        st, loss = make_train_step(TINY, tx, mesh=grid)(st, px, tok)
        runs.append((st, float(loss)))
    (tp, loss2), (again, loss2b) = runs
    np.testing.assert_allclose(loss2, float(loss1), rtol=2e-5)
    np.testing.assert_allclose(loss2, jax_tp["loss"], rtol=2e-5)
    params = _tree_of(tp.params)
    _leaf_close(jax_tp["params"], params, 0.0, 1e-6)
    _leaf_close(_tree_of(one.params), params, 0.0, 1e-6)
    _leaf_close(jax_tp["mu"], _tree_of(tp.params, tp.opt_state.mu), 1e-4, 1e-10)
    _leaf_close(jax_tp["nu"], _tree_of(tp.params, tp.opt_state.nu), 1e-4, 1e-14)
    # every reduce sums in shard order: the step repeats bit for bit
    assert loss2b == loss2
    for (n, p), (_, q) in zip(tp.params.named_parameters(), again.params.named_parameters()):
        assert torch.equal(p, q), n


def test_checkpoint_restore_sharded(tmp_path, tree7, jax_tp):
    tx = make_optimizer()
    grid = make_mesh(model_parallel=2, devices=CPU8)
    step = make_train_step(TINY, tx, mesh=grid)
    px, tok = _batch(1, 8)
    px2, tok2 = _batch(2, 8)
    state, _ = init_train_state(tree7, TINY, tx, mesh=grid)
    state, _ = step(state, px, tok)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_dir, state)
    jax_ckpt.save_checkpoint(jax_dir, jax_tp["state"])
    with np.load(f"{port_dir}/step_00000001.npz") as z, np.load(f"{jax_dir}/step_00000001.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        assert all(z[k].shape == zj[k].shape and z[k].dtype == zj[k].dtype for k in z.files)
        saved = {k: z[k] for k in z.files}
    _, loss = step(state, px2, tok2)  # uninterrupted

    # the port restores its own (4, 2) checkpoint at (4, 2) and on one device
    fresh, _ = init_train_state(0, TINY, tx, mesh=grid)
    restored = restore_checkpoint(port_dir, fresh, mesh=grid, param_specs=clip_param_specs())
    _, loss_r = step(restored, px2, tok2)
    assert float(loss_r) == float(loss)
    single, _ = init_train_state(0, TINY, tx, device="cpu")
    single = restore_checkpoint(port_dir, single)
    _, loss_s = make_train_step(TINY, tx)(single, px2, tok2)
    np.testing.assert_allclose(float(loss_s), float(loss), rtol=1e-6)
    with pytest.raises(ValueError):
        restore_checkpoint(port_dir, single, mesh=grid)

    # JAX's (4, 2) checkpoint in the port at (4, 2): the leaves exactly the file's
    fresh, _ = init_train_state(0, TINY, tx, mesh=grid)
    from_jax = restore_checkpoint(jax_dir, fresh, mesh=grid, param_specs=clip_param_specs())
    with np.load(f"{jax_dir}/step_00000001.npz") as zj:
        want = {k[len("params/") :]: zj[k] for k in zj.files if k.startswith("params/")}
    got = {"/".join(p): v for p, v in _flat(_tree_of(from_jax.params)).items()}
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    _, loss_pj = step(from_jax, px2, tok2)

    # the port's (4, 2) checkpoint in JAX at (4, 2): JAX's next step
    mesh = jax_tp["mesh"]
    template, _ = jax_train.init_train_state(jax.random.key(0), JTINY, jax_tp["tx"], mesh=mesh)
    jst = jax_ckpt.restore_checkpoint(
        port_dir, template, mesh=mesh, param_specs=jax_sharding.clip_param_specs()
    )
    assert all(
        np.array_equal(np.asarray(v), saved["params/" + "/".join(p)])
        for p, v in _flat(jax.tree.map(np.asarray, jst.params)).items()
    )
    _, loss_j = jax_tp["step"](jst, jnp.asarray(px2), jnp.asarray(tok2))
    np.testing.assert_allclose(float(loss_j), float(loss), rtol=2e-5)
    np.testing.assert_allclose(float(loss_pj), float(loss_j), rtol=2e-5)


def test_train_cli_mp2_resumes_at_mp4(tmp_path, caplog):
    """``--mp 2`` over four logical CPU devices (a batch of 5 rounded up to
    the data axis), then ``--resume`` at ``--mp 4``: the checkpoint is
    re-sharded."""
    ck = str(tmp_path / "ck")
    common = ["--config", "tiny", "--batch", "5", "--synthetic", "8", "--ckpt-dir", ck]
    devices = ["--device", "cpu,cpu,cpu,cpu"]
    caplog.set_level(logging.INFO, logger="imatch.train")
    first = train_clip.train(train_clip.parse_args(common + devices + ["--steps", "3", "--mp", "2"]))
    assert first.rc == 0 and first.state.step == 3 and len(first.state.params.peers) == 1
    assert "mesh: data=2 model=2 (cpu)" in caplog.messages
    assert "batch 5 not divisible by data-parallel size 2; using 6" in caplog.messages
    assert "done at step 3" in caplog.messages and all(np.isfinite(first.losses))
    caplog.clear()
    second = train_clip.train(
        train_clip.parse_args(common + devices + ["--steps", "5", "--mp", "4", "--resume"])
    )
    assert second.rc == 0 and len(second.state.params.peers) == 3
    assert "mesh: data=1 model=4 (cpu)" in caplog.messages
    assert "resumed from step 3" in caplog.messages and "done at step 5" in caplog.messages


# -- the Moondream prefill under TP --------------------------------------------------


@pytest.fixture(scope="module")
def md():
    """JAX's TINY_MD tree, the inputs of JAX's test, and JAX's prefill
    logits on one device and over the (4, 2) mesh by ``md_param_specs``."""
    params = init_md_params(jax.random.key(0), JAX_TINY_MD)
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 5)).astype(np.int32)

    def fwd(p, pixels, tokens):
        feats = jax_encode(p, pixels, JAX_TINY_MD)
        logits, _, _ = jax_prefill(p, JAX_TINY_MD, feats, tokens)
        return logits

    mesh = jax_mesh.make_mesh(model_parallel=2)
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, jax_sharding.md_param_specs()
    )
    args = (jnp.asarray(pixels), jnp.asarray(tokens))
    return {
        "tree": jax.tree.map(np.asarray, params),
        "pixels": pixels,
        "tokens": tokens,
        "one": np.asarray(jax.jit(fwd)(params, *args)),
        "tp": np.asarray(jax.jit(fwd)(sharded, *args)),
    }


@pytest.mark.parametrize("mp", [2, 4])
def test_moondream_tp_matches_jax_and_one_device(md, mp):
    one = md_params_from_numpy(md["tree"], TINY_MD)
    tp = shard_model(one, ["cpu"] * mp)
    px, tok = torch.from_numpy(md["pixels"]), torch.from_numpy(md["tokens"]).long()
    outs = {}
    for name, model in (("one", one), ("tp", tp)):
        feats = encode_image_features(model, px)
        outs[name] = prefill(model, feats, tok, max_new=4)
    logits, cache, pos = outs["tp"]
    bar = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(logits.numpy(), md["tp"], **bar)
    np.testing.assert_allclose(logits.numpy(), outs["one"][0].numpy(), **bar)
    np.testing.assert_allclose(outs["one"][0].numpy(), md["one"], **bar)
    # the cache split by heads, each shard's equal to the one-device cache's heads
    heads = TINY_MD.text.num_heads // mp
    assert len(cache) == mp and all(c.k.shape[2] == heads for c in cache)
    full = outs["one"][1]
    for m, c in enumerate(cache):
        torch.testing.assert_close(c.k, full.k[:, :, m * heads : (m + 1) * heads], rtol=1e-5, atol=1e-6)
    got = greedy_generate(tp, logits, cache, pos, max_new=4)
    want = greedy_generate(one, *outs["one"], max_new=4)
    assert torch.equal(got.tokens, want.tokens)


def test_moondream_tp_refuses_the_int8_modes(md):
    from imatch_tpu_torch.models.moondream.model import quantize_int8

    one = md_params_from_numpy(md["tree"], TINY_MD)
    with pytest.raises(ValueError, match="one device"):
        shard_model(quantize_int8(md_params_from_numpy(md["tree"], TINY_MD)), ["cpu"] * 2)
    tp = shard_model(one, ["cpu"] * 2)
    feats = encode_image_features(tp, torch.from_numpy(md["pixels"]))
    with pytest.raises(ValueError, match="one device"):
        prefill(tp, feats, torch.from_numpy(md["tokens"]).long(), act_quant=True)
