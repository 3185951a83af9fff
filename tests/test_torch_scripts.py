"""The port's operations scripts (imatch_tpu_torch/scripts/) on the CPU.

- ``init_index`` run twice: "initialized empty index", then "existing
  index" (tests/test_client.py:144 on the port).
- The 7 cases of tests/test_migrate.py on the port's ``migrate``, against
  the same synthetic Chroma sqlite layout (collections, segments,
  embeddings, embedding_metadata and the embeddings_queue WAL): ids,
  typed metadata, documents and WAL replay, the 0.4.x layout without a
  topic column, pruned rows (an error, ``skip_missing``, ``reembed``), a
  dry run, bind chunks past 999 rows and an unknown collection. Then a
  directory the port's migration writes loads in the JAX ``VectorStore``
  with the same ids, vectors, metadata and documents.
- ``ingest_folder`` over 8 frames with the tiny CLIP config: exit status
  0 and its progress and summary lines (as a command); again with an
  undecodable file beside them (``main`` in this process): status 1, 8
  duplicates and 1 error.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.scripts import ingest_folder
from imatch_tpu_torch.scripts.migrate_from_reference import migrate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 48  # the tiny CLIP config's, so --reembed rows agree

_OPS = {"add": 0, "update": 1, "upsert": 2, "delete": 3}


def _run(module, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"imatch_tpu_torch.scripts.{module}", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
        timeout=300,
    )


def test_init_index_script_is_idempotent(tmp_path):
    r = _run("init_index", str(tmp_path), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "initialized empty index" in r.stdout and "static dirs ready" in r.stdout
    for sub in ("uploads", "processed", "encoded"):
        assert (tmp_path / "static" / sub).is_dir()
    r2 = _run("init_index", str(tmp_path), env={"IMATCH_DEVICE": "cpu"})
    assert r2.returncode == 0, r2.stderr
    assert "existing index" in r2.stdout and ": 0 records" in r2.stdout


# -- migrate_from_reference: the synthetic Chroma layout of tests/test_migrate.py


def _vec(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(DIM,)).astype("<f4")


def _create_schema(con, topic_column=True):
    """The sqlite DDL Chroma 0.4-0.6 writes."""
    con.executescript(
        """
        CREATE TABLE collections (
            id TEXT PRIMARY KEY, name TEXT, dimension INTEGER);
        CREATE TABLE segments (
            id TEXT PRIMARY KEY, type TEXT, scope TEXT, collection TEXT);
        CREATE TABLE embeddings (
            id INTEGER PRIMARY KEY AUTOINCREMENT, segment_id TEXT,
            embedding_id TEXT, seq_id BLOB, created_at TEXT);
        CREATE TABLE embedding_metadata (
            id INTEGER, key TEXT, string_value TEXT, int_value INTEGER,
            float_value REAL, bool_value INTEGER);
        """
    )
    topic = " topic TEXT," if topic_column else ""
    con.execute(
        "CREATE TABLE embeddings_queue (seq_id INTEGER PRIMARY KEY,"
        f" created_at TEXT, operation INTEGER,{topic} id TEXT,"
        " vector BLOB, encoding TEXT, metadata TEXT)"
    )


def make_chroma_db(dirpath, *, prune_wal_for=(), topic_column=True, ids=None):
    """A synthetic reference deployment. By default three live rows with
    WAL add/update/delete replay and typed metadata; with ``ids``, an
    N-row corpus (one filename and one WAL add an id)."""
    os.makedirs(dirpath, exist_ok=True)
    con = sqlite3.connect(os.path.join(dirpath, "chroma.sqlite3"))
    _create_schema(con, topic_column=topic_column)
    con.execute("INSERT INTO collections VALUES ('col-1', 'image-match', ?)", (DIM,))
    con.executemany(
        "INSERT INTO segments VALUES (?, ?, ?, 'col-1')",
        [
            ("seg-md", "urn:chroma:segment/metadata/sqlite", "METADATA"),
            ("seg-vec", "urn:chroma:segment/vector/hnsw-local", "VECTOR"),
        ],
    )
    wal_sql = (
        "INSERT INTO embeddings_queue VALUES (?, '', ?, 'persistent://default/default/col-1', ?, ?, 'FLOAT32', '{}')"
        if topic_column
        else "INSERT INTO embeddings_queue VALUES (?, '', ?, ?, ?, 'FLOAT32', '{}')"
    )
    if ids is not None:
        rows = list(enumerate(ids, start=1))
        con.executemany("INSERT INTO embeddings (id, segment_id, embedding_id) VALUES (?, 'seg-md', ?)", rows)
        con.executemany(
            "INSERT INTO embedding_metadata VALUES (?, 'filename', ?, NULL, NULL, NULL)",
            [(pk, f"{i}.jpg") for pk, i in rows],
        )
        con.executemany(wal_sql, [(pk, 0, i, _vec(pk).tobytes()) for pk, i in rows])
        con.commit()
        con.close()
        return
    # live: img_a, img_b, img_c; img_d was added then deleted (WAL only)
    live = ((1, "img_a"), (2, "img_b"), (3, "img_c"))
    con.executemany("INSERT INTO embeddings (id, segment_id, embedding_id) VALUES (?, 'seg-md', ?)", live)
    meta_rows = []
    for pk, emb_id in live:
        meta_rows += [
            (pk, "id", emb_id, None, None, None),
            (pk, "filename", f"{emb_id}.jpg", None, None, None),
            (pk, "description", f"desc {emb_id}", None, None, None),
            (pk, "url", f"/static/processed/{emb_id}.png", None, None, None),
            (pk, "created_at", "2025-03-28T12:00:00", None, None, None),
            (pk, "chroma:document", f"desc {emb_id}", None, None, None),
        ]
    meta_rows += [
        (1, "filter_results_json", '{"is it red": "yes"}', None, None, None),
        (1, "views", None, 7, None, None),
        (2, "score", None, None, 0.5, None),
        (3, "flagged", None, None, None, 1),
    ]
    con.executemany("INSERT INTO embedding_metadata VALUES (?, ?, ?, ?, ?, ?)", meta_rows)
    # WAL replay: add a(v1), add b, add d, delete d, update a(v2), add c
    wal = [
        (1, _OPS["add"], "img_a", _vec(1).tobytes()),
        (2, _OPS["add"], "img_b", _vec(2).tobytes()),
        (3, _OPS["add"], "img_d", _vec(4).tobytes()),
        (4, _OPS["delete"], "img_d", None),
        (5, _OPS["update"], "img_a", _vec(11).tobytes()),
        (6, _OPS["add"], "img_c", _vec(3).tobytes()),
    ]
    con.executemany(wal_sql, [r for r in wal if r[2] not in prune_wal_for])
    con.commit()
    con.close()


def _migrate(tmp_path, **kw):
    kw.setdefault("device", "cpu")
    return migrate(chroma_dir=str(tmp_path / "chroma_data"), root=str(tmp_path), collection="image-match", **kw)


def _load(tmp_path):
    return VectorStore.load(str(tmp_path / "index_data"), persist=False, device="cpu")


def test_migrate_full_wal(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"))
    summary = _migrate(tmp_path)
    assert summary["rows_migrated"] == 3
    assert summary["vectors_from_wal"] == 3
    assert summary["rows_dropped"] == 0
    got = _load(tmp_path).get(include=["metadatas", "documents", "embeddings"])
    by_id = dict(zip(got["ids"], got["embeddings"]))
    assert set(by_id) == {"img_a", "img_b", "img_c"}
    np.testing.assert_allclose(by_id["img_a"], _vec(11), rtol=1e-6)  # the update replayed
    np.testing.assert_allclose(by_id["img_b"], _vec(2), rtol=1e-6)
    md = dict(zip(got["ids"], got["metadatas"]))
    assert md["img_a"]["filter_results_json"] == '{"is it red": "yes"}'
    assert md["img_a"]["views"] == 7
    assert md["img_b"]["score"] == 0.5
    assert md["img_c"]["flagged"] is True
    assert "chroma:document" not in md["img_a"]
    assert dict(zip(got["ids"], got["documents"]))["img_b"] == "desc img_b"


def test_migrate_wal_without_topic_column(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"), topic_column=False)
    assert _migrate(tmp_path)["rows_migrated"] == 3


def test_migrate_pruned_wal_requires_choice(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"), prune_wal_for=("img_c",))
    with pytest.raises(SystemExit, match="no vector in"):
        _migrate(tmp_path)
    summary = _migrate(tmp_path, skip_missing=True)
    assert summary["rows_migrated"] == 2
    assert summary["rows_dropped"] == 1
    assert set(_load(tmp_path).get()["ids"]) == {"img_a", "img_b"}


def test_migrate_reembed_fallback(tmp_path, monkeypatch):
    monkeypatch.setenv("IMATCH_CLIP_CONFIG", "tiny")
    make_chroma_db(str(tmp_path / "chroma_data"), prune_wal_for=("img_c",))
    processed = tmp_path / "static" / "processed"
    processed.mkdir(parents=True)
    Image.new("RGB", (40, 40), (200, 30, 30)).save(processed / "img_c.png")
    summary = _migrate(tmp_path, reembed=True)
    assert summary["rows_migrated"] == 3
    assert summary["vectors_reembedded"] == 1
    got = _load(tmp_path).get(include=["embeddings"])
    v = np.asarray(dict(zip(got["ids"], got["embeddings"]))["img_c"], np.float32)
    assert v.shape == (DIM,)  # a real unit embedding of the right width
    assert abs(float(np.linalg.norm(v)) - 1.0) < 1e-3


def test_migrate_dry_run_writes_nothing(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"))
    assert _migrate(tmp_path, dry_run=True)["rows_live"] == 3
    assert not (tmp_path / "index_data").exists()


def test_migrate_many_rows_crosses_bind_chunks(tmp_path):
    """1,203 rows: the metadata IN() query is chunked under SQLite's bind
    cap, and rows on both sides of each chunk edge keep their metadata."""
    n = 1203
    ids = [f"img_{i:05d}" for i in range(n)]
    make_chroma_db(str(tmp_path / "chroma_data"), ids=ids)
    assert _migrate(tmp_path)["rows_migrated"] == n
    got = _load(tmp_path).get(include=["metadatas"])
    md = dict(zip(got["ids"], got["metadatas"]))
    assert len(md) == n
    for probe in (0, 499, 500, 999, 1000, n - 1):
        assert md[ids[probe]]["filename"] == f"{ids[probe]}.jpg"


def test_migrate_unknown_collection(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"))
    with pytest.raises(SystemExit, match="not found"):
        migrate(chroma_dir=str(tmp_path / "chroma_data"), root=str(tmp_path), collection="nope", device="cpu")


def test_migrated_directory_loads_in_the_jax_store(tmp_path):
    make_chroma_db(str(tmp_path / "chroma_data"))
    _migrate(tmp_path)
    include = ["metadatas", "documents", "embeddings"]
    port = _load(tmp_path).get(include=include)
    jax_got = JaxStore.load(str(tmp_path / "index_data"), persist=False).get(include=include)
    assert jax_got["ids"] == port["ids"]
    np.testing.assert_array_equal(np.asarray(jax_got["embeddings"]), np.asarray(port["embeddings"]))
    assert jax_got["metadatas"] == port["metadatas"]
    assert jax_got["documents"] == port["documents"]


@pytest.mark.parametrize("script", ["init_index", "migrate_from_reference"])
def test_script_runs_on_the_card_unless_asked(tmp_path, monkeypatch, script):
    """With no --device and no IMATCH_DEVICE the script takes ``cuda``: on
    a machine without a card it refuses, and never moves to the CPU."""
    from imatch_tpu_torch.scripts import init_index, migrate_from_reference

    make_chroma_db(str(tmp_path / "chroma_data"))
    monkeypatch.delenv("IMATCH_DEVICE", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = {
        "init_index": [str(tmp_path)],
        "migrate_from_reference": ["--chroma-dir", str(tmp_path / "chroma_data"), "--root", str(tmp_path)],
    }[script]
    main = {"init_index": init_index.main, "migrate_from_reference": migrate_from_reference.main}[script]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "index_data").exists()
    monkeypatch.setenv("IMATCH_DEVICE", "cpu")
    main(argv)
    assert _load(tmp_path).count() == (0 if script == "init_index" else 3)


# -- ingest_folder -------------------------------------------------------------


def test_ingest_folder_cli(tmp_path, monkeypatch, caplog):
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(8):
        rng = np.random.default_rng(i)
        Image.fromarray(rng.integers(0, 256, (40 + i, 56, 3), np.uint8)).save(folder / f"f{i}.png")
    env = {"IMATCH_CLIP_CONFIG": "tiny", "IMATCH_SEGMENTER": "null"}
    args = (str(folder), "--root", str(tmp_path / "app"), "--batch", "4", "--captioner", "null", "--device", "cpu")
    r = _run("ingest_folder", *args, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "4/8 (" in r.stderr and "8/8 (" in r.stderr
    assert "done: 8 indexed, 0 duplicates, 0 errors" in r.stderr
    assert _load(tmp_path / "app").count() == 8

    # again in this process, with an undecodable file beside the frames
    (folder / "broken.png").write_bytes(b"not an image")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("IMATCH_CAPTIONER", "null")
    with caplog.at_level(logging.INFO, logger="imatch.ingest_folder"):
        assert ingest_folder.main(list(args)) == 1
    assert "decode failed" in caplog.text
    assert "done: 0 indexed, 8 duplicates, 1 errors" in caplog.text
