"""The grid across processes: each path over gloo processes on the CPU.

``python -m imatch_tpu_torch.scripts.dryrun_multiprocess`` runs two sets
of workers (each under its own timeout) with tiny configs, and every
worker checks itself against the one-process answer; this module then
compares the results the workers leave under ``--out`` with the same grid
shape in this process and with the JAX package:

- ``ivf-sharded`` over 2 processes x 2 shards: bit for bit the
  one-process 4-shard engine (ids and scores), ids equal to JAX's
  ``sharded_ivf_topk`` on a 4-device virtual CPU mesh (scores within
  1e-5), at a full probe the ``sharded`` store's; an add and a delete
  patch it, and a sidecar saved by a worker reloads in a one-process store
  that repairs it;
- the TP forward at mp = 2 over 2 processes: the one-process mp = 2
  forward within rtol 1e-6;
- the (2, 2) DP + TP step over 4 processes, from ``jax.random.key(7)``
  carried across: its loss within rtol 1e-6 of the one-process (2, 2)
  grid's and 2e-5 of JAX's (tests/test_torch_parallel.py's bars), and the
  parameters after the step within test_torch_parallel.py's ``_leaf_close``
  bars of both;
- ring attention across 2 processes (4 positions): forward and gradient
  within 1e-5 of ``mha_xla``;
- GPipe across 2 processes: the one-process ``gpipe_scan``;
- the embedder over a spanning grid keeps the grid's shard count, each
  process running its own block only, and equals the one-process grid.

JAX's 4-device answers run in a process of their own with 4 virtual host
devices (``_JAX_SCRIPT``): collectives over a subset of this process's 8
devices beside the suite's 8-device ones can stall XLA:CPU.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.models.clip.model import init_params
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.models.clip.bridge import named_to_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.clip.model import encode_image, encode_text, init_random
from imatch_tpu_torch.ops.attention import mha_xla
from imatch_tpu_torch.parallel import gpipe_scan, init_train_state, make_mesh, make_train_step
from imatch_tpu_torch.parallel.sharding import gather_named, shard_model
from imatch_tpu_torch.parallel.train import make_optimizer
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.scripts.dryrun_multiprocess import clip_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS_A = "ivf,tp,embed,ring,gpipe"
ARGS_A = ["--procs", "2", "--local-devices", "2", "--rows", "2048", "--dim", "32", "--queries", "8"]
ARGS_B = ["--procs", "4", "--mp", "2", "--steps", "1", "--train-batch", "8"]
SEED = 0  # the dryrun's default --seed
_JAX_SCRIPT = """
import sys
import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
from imatch_tpu.models.clip import configs
from imatch_tpu.parallel import dist_ivf, mesh, train
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.scripts.dryrun_multiprocess import clip_batch

assert len(jax.devices()) == 4
out = {}
with np.load(sys.argv[1]) as z:
    corpus, queries = z["corpus"], z["queries"]
index = dist_ivf.prepare_sharded_ivf(corpus, np.ones(len(corpus), bool), mesh=mesh.make_mesh())
s, i = dist_ivf.sharded_ivf_topk(jnp.asarray(queries), index, k=10, n_probe=8)
out["ivf_scores"], out["ivf_ids"] = np.asarray(s), np.asarray(i)
grid = mesh.make_mesh(model_parallel=2)
tx = train.make_optimizer()
state, _ = train.init_train_state(jax.random.key(7), configs.TINY, tx, mesh=grid)
px, tok = clip_batch(TINY, 8, int(sys.argv[3]))
state, loss = train.make_train_step(configs.TINY, tx, mesh=grid)(state, jnp.asarray(px), jnp.asarray(tok))
out["loss"] = np.asarray(float(loss))
for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
    out["params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _flat(tree, prefix=()):
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


def _launch(out, *args):
    # one compute thread a worker: the suite's other files run beside them
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "imatch_tpu_torch.scripts.dryrun_multiprocess", "--device", "cpu"]
    cmd += ["--timeout", "150", "--write", "--out", str(out), *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _rows(stdout):
    rows = {}
    for line in stdout.splitlines():
        if line.startswith("[proc ") and "] {" in line:
            head, body = line.split("] ", 1)
            rows[int(head[len("[proc ") :])] = json.loads(body)
    return rows


@pytest.fixture(scope="module")
def tree7():
    return jax.tree.map(np.asarray, init_params(jax.random.key(7), jax_configs.TINY))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tree7):
    """Both sets of workers, one after the other: (a) 2 processes for
    ivf, tp, embed, ring and gpipe, (b) 4 processes for the (2, 2) step
    from ``tree7``. Each worker's JSON line, and the directories."""
    out_a, out_b = tmp_path_factory.mktemp("grid_a"), tmp_path_factory.mktemp("grid_b")
    init = out_b / "tree7.npz"
    np.savez(init, **{"/".join(k): v for k, v in _flat(tree7).items()})
    outs = []
    for out, args in (
        (out_a, ("--paths", PATHS_A, *ARGS_A)),
        (out_b, ("--paths", "train", "--init-npz", str(init), *ARGS_B)),
    ):
        p = _launch(out, *args)
        try:
            text = p.communicate(timeout=200)[0]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert p.returncode == 0 and "MULTIPROCESS DRYRUN OK" in text, text[-3000:]
        outs.append(text)
    return {"a": _rows(outs[0]), "b": _rows(outs[1]), "out_a": out_a, "out_b": out_b}


def _ivf(runs, proc):
    with open(runs["out_a"] / f"ivf_results_p{proc}.json") as f:
        res = json.load(f)
    with np.load(runs["out_a"] / f"ivf_arrays_p{proc}.npz") as z:
        return res, {k: z[k] for k in z.files}


def _one_process_store(arrays):
    corpus = arrays["corpus"]
    ids = [f"v{j:07d}" for j in range(corpus.shape[0])]
    store = VectorStore(dim=corpus.shape[1], engine="ivf-sharded", device="cpu", mesh=["cpu"] * 4)
    store.add(ids=ids[:-16], embeddings=corpus[:-16])
    return store


def _lists(res):
    return {k: res[k] for k in ("ids", "distances")}


def test_ivf_sharded_equals_the_one_process_engine(runs, monkeypatch):
    res0, arrays = _ivf(runs, 0)
    store = _one_process_store(arrays)
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "8")
    want = store.query(arrays["queries"], n_results=10)
    for proc in (0, 1):
        res, _ = _ivf(runs, proc)
        assert _lists(res["probe8"]) == _lists(want)
    # an add through the append patch and a delete, as the workers made them
    store.delete([want["ids"][0][0]])
    store.add(ids=["added"], embeddings=arrays["queries"][1:2])
    assert _lists(res0["mutated"]) == _lists(store.query(arrays["queries"], n_results=10))
    assert store.stats()["patched_mutations"] == 2


@pytest.fixture(scope="module")
def jax4(runs, tmp_path_factory):
    """JAX on a 4-device virtual CPU mesh, in a process of its own:
    ``sharded_ivf_topk`` at n_probe 8 over the workers' corpus, and the
    (2, 2) step from ``jax.random.key(7)`` on the workers' batch (its loss
    and parameters)."""
    out = tmp_path_factory.mktemp("jax4") / "jax4.npz"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    args = [str(runs["out_a"] / "ivf_arrays_p0.npz"), str(out), str(SEED + 100)]
    done = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, *args], capture_output=True, text=True, timeout=200, env=env, cwd=REPO
    )
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-3000:]
    with np.load(out) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, leaf in flat.items():
        if key.startswith("params/"):
            *head, name = key.split("/")[1:]
            node = params
            for k in head:
                node = node.setdefault(k, {})
            node[name] = leaf
    return {"ivf_scores": flat["ivf_scores"], "ivf_ids": flat["ivf_ids"], "loss": float(flat["loss"]), "params": params}


def test_ivf_sharded_ids_match_jax(runs, jax4):
    for proc in (0, 1):
        _, arrays = _ivf(runs, proc)
        np.testing.assert_array_equal(arrays["lib_ids"], jax4["ivf_ids"])
        np.testing.assert_allclose(arrays["lib_scores"], jax4["ivf_scores"], rtol=0, atol=1e-5)


def test_ivf_sharded_full_probe_equals_sharded(runs):
    for proc in (0, 1):
        res, _ = _ivf(runs, proc)
        assert res["full"] == res["sharded"]
        assert runs["a"][proc]["ivf"]["shards"] == 4


def test_ivf_sharded_sidecar_reloads_in_one_process(runs, monkeypatch):
    res, _ = _ivf(runs, 1)
    assert runs["a"][1]["ivf"]["sidecar_modes"] == ["repair", "repair"]
    monkeypatch.setenv("IMATCH_INDEX_ENGINE", "ivf-sharded")
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "8")
    back = VectorStore.load(str(runs["out_a"] / "ivf_p1"), persist=False, device="cpu", mesh=["cpu"] * 4)
    _, arrays = _ivf(runs, 1)
    assert _lists(back.query(arrays["queries"], n_results=10)) == _lists(res["probe8"])
    assert back.stats()["ivf"]["last_mode"] == "repair"


def test_tp_forward_over_processes_matches_one_process(runs):
    full = init_random(TINY, device="cpu", dtype=torch.float32, generator=torch.Generator().manual_seed(SEED))
    model = shard_model(full, make_mesh(2, ["cpu"] * 2))
    px, tok = (torch.from_numpy(a) for a in clip_batch(TINY, 4, SEED + 1))
    img, txt = encode_image(model, px).numpy(), encode_text(model, tok).numpy()
    for proc in (0, 1):
        with np.load(runs["out_a"] / f"tp_p{proc}.npz") as z:
            np.testing.assert_allclose(z["img"], img, rtol=1e-6, atol=0)
            np.testing.assert_allclose(z["txt"], txt, rtol=1e-6, atol=0)
        assert runs["a"][proc]["tp"]["grid"] == {"data": 1, "model": 2}


def test_dp_tp_step_over_processes_matches_one_process_and_jax(runs, tree7, jax4):
    tx = make_optimizer()
    grid = make_mesh(model_parallel=2, devices=["cpu"] * 4)
    state, _ = init_train_state(tree7, TINY, tx, mesh=grid)
    state, loss = make_train_step(TINY, tx, mesh=grid)(state, *clip_batch(TINY, 8, SEED + 100))
    one = named_to_numpy(gather_named(dict(state.params.named_parameters()), state.params), TINY)
    with np.load(runs["out_b"] / "train_params.npz") as z:
        losses = z["losses"]
        got = {tuple(k.split("/")): z[k] for k in z.files if k != "losses"}
    tree = {}
    for path, leaf in got.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-6)
    np.testing.assert_allclose(losses[0], jax4["loss"], rtol=2e-5)
    _leaf_close(one, tree, 0.0, 1e-6)
    _leaf_close(jax4["params"], tree, 0.0, 1e-6)
    for row in runs["b"].values():
        assert row["train"]["grid"] == {"data": 2, "model": 2}
        assert row["train"]["restored_mp1_max_abs_diff"] == 0.0


def test_ring_over_processes_matches_mha_xla(runs):
    for proc in (0, 1):
        with np.load(runs["out_a"] / f"ring_p{proc}.npz") as z:
            q, k, v = (torch.from_numpy(z[n]).requires_grad_(True) for n in "qkv")
            want = mha_xla(q, k, v, causal=True)
            want.sum().backward()
            np.testing.assert_allclose(z["out"], want.detach().numpy(), rtol=1e-5, atol=1e-5)
            for name, t in zip(("gq", "gk", "gv"), (q, k, v)):
                np.testing.assert_allclose(z[name], t.grad.numpy(), rtol=1e-5, atol=1e-5)
        assert runs["a"][proc]["ring"]["ring_size"] == 4


def test_gpipe_over_processes_matches_one_process(runs):
    g = torch.Generator().manual_seed(SEED + 43)
    encoder = init_random(TINY, device="cpu", dtype=torch.float32, generator=g).vision.encoder
    vc = TINY.vision
    x = torch.randn((8, vc.seq_len, vc.hidden_size), generator=g)
    with torch.no_grad():
        want = gpipe_scan(lambda h, lp: (lp(h, False), None), x, encoder.layers, mesh=make_mesh(["cpu"] * 2), axis="data", microbatches=4)
    for proc in (0, 1):
        with np.load(runs["out_a"] / f"gpipe_p{proc}.npz") as z:
            np.testing.assert_array_equal(z["got"], want.numpy())
        assert runs["a"][proc]["gpipe"]["grad_refused"]


def test_embedder_keeps_the_spanning_grid(runs):
    """Each process holds one shard of the 2-shard grid (the grid a list
    of its devices gives again, never a grid of 4) and runs one block of
    the padded batch of 4 a chunk: its own."""
    rng = np.random.default_rng(SEED + 5)
    frames = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8) for _ in range(4)]
    want = ClipEmbedder("tiny", device="cpu", mesh=["cpu"] * 2).embed_images(frames)
    for proc in (0, 1):
        row = runs["a"][proc]["embed"]
        assert row["shards"] == 2 and row["tower_blocks"] == [2]
        with np.load(runs["out_a"] / f"embed_p{proc}.npz") as z:
            np.testing.assert_array_equal(z["got"], want)
