"""Migrate a reference ("ImageMatch") deployment into the port's store.

Port of ``scripts/migrate_from_reference.py``, whose snapshot it writes
byte for byte in the same layout: a directory this script writes loads in
either package's ``VectorStore``. The reference persists its index in
ChromaDB's on-disk layout (``chroma_data/chroma.sqlite3``): ids, metadata
and documents live in sqlite tables (``embeddings`` +
``embedding_metadata``), and, because Chroma keeps its write-ahead log in
the same file, the full fp32 vectors are normally recoverable from the
``embeddings_queue`` table without chromadb. This script reads that
layout with stdlib sqlite3 and writes a ``VectorStore`` snapshot,
preserving:

- every image id (the pHash-derived ``img_<hex>``; the port's pHash is
  bit-identical to imagehash.phash, so later dedup checks keep working
  against migrated ids);
- every metadata record verbatim, including captions appended to
  ``custom_metadata`` and the ``filter_results_json`` of the reference's
  filter backfill (AND-filtered search works on day one);
- documents (the description, under Chroma's ``chroma:document`` key);
- the embeddings themselves where the WAL still has them (Chroma <= 0.5.5
  never pruned it).

For rows whose vectors were pruned from the WAL, ``--reembed`` decodes
``static/processed/<id>.png`` with the native decode pool and embeds it
with the configured CLIP tower (IMATCH_CLIP_CONFIG /
IMATCH_CLIP_CHECKPOINT; use the reference's LongCLIP weights for drop-in
score parity). Static assets need no migration: serve from the
reference's backend root and ``static/{uploads,processed,encoded}`` and
``filters.json`` are used in place (encoded/*.pt Moondream tensors do not
transfer; they are re-encoded lazily when a filter backfill needs them).

Usage:
  python -m imatch_tpu_torch.scripts.migrate_from_reference \
      --chroma-dir chroma_data --root . [--collection image-match] \
      [--reembed] [--skip-missing] [--dry-run] [--device cuda|cpu]

The store and any re-embedding run on ``cuda``, where ``--reembed`` runs
the image tower (K2), unless ``--device cpu`` or IMATCH_DEVICE=cpu asks
for the CPU (the JAX script's ``--platform cpu``, which this replaces).

Schema notes: written against Chroma 0.4.x-0.6.x (the reference pins
chromadb>=0.4.13). Column sets are introspected per table, so minor
schema drift across those versions is tolerated.
"""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

from imatch_tpu_torch.device import DeviceLike, resolve_device

# Chroma Operation enum wire values (chromadb/types.py): the WAL stores
# these ints in embeddings_queue.operation.
_OP_ADD, _OP_UPDATE, _OP_UPSERT, _OP_DELETE = 0, 1, 2, 3

# Chroma stores the document text as a reserved metadata key.
_DOC_KEY = "chroma:document"


def _columns(con: sqlite3.Connection, table: str) -> List[str]:
    return [r[1] for r in con.execute(f"PRAGMA table_info({table})")]


def _has_table(con: sqlite3.Connection, table: str) -> bool:
    return (
        con.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?",
            (table,),
        ).fetchone()
        is not None
    )


def _find_collection(
    con: sqlite3.Connection, name: str
) -> Tuple[str, Optional[int]]:
    """Return (collection_id, dimension)."""
    cols = _columns(con, "collections")
    sel = ["id"]
    sel.append("dimension" if "dimension" in cols else "NULL")
    row = con.execute(
        f"SELECT {', '.join(sel)} FROM collections WHERE name = ?", (name,)
    ).fetchone()
    if row is None:
        names = [
            r[0] for r in con.execute("SELECT name FROM collections")
        ]
        raise SystemExit(
            f"collection {name!r} not found in chroma db "
            f"(collections present: {names})"
        )
    return str(row[0]), (int(row[1]) if row[1] is not None else None)


def _metadata_segment(con: sqlite3.Connection, collection_id: str) -> str:
    cols = _columns(con, "segments")
    if "collection" in cols:
        rows = con.execute(
            "SELECT id, scope FROM segments WHERE collection = ?",
            (collection_id,),
        ).fetchall()
    else:
        # chroma 0.4.x: segments carry a pulsar-style topic string that
        # embeds the collection uuid
        rows = con.execute(
            "SELECT id, scope FROM segments WHERE topic LIKE ?",
            (f"%{collection_id}%",),
        ).fetchall()
    for seg_id, scope in rows:
        if str(scope).upper() == "METADATA":
            return str(seg_id)
    raise SystemExit(
        f"no METADATA segment for collection {collection_id} "
        f"(segments: {rows})"
    )


def read_records(
    con: sqlite3.Connection, metadata_segment: str
) -> List[Tuple[str, dict, Optional[str]]]:
    """Live rows from the metadata segment: (embedding_id, metadata,
    document), in insertion order. This table is authoritative — Chroma
    applies deletes to it synchronously."""
    rows = con.execute(
        "SELECT id, embedding_id FROM embeddings WHERE segment_id = ? "
        "ORDER BY id",
        (metadata_segment,),
    ).fetchall()
    metas: Dict[int, dict] = {int(pk): {} for pk, _ in rows}
    # Chunk the IN() binds: SQLite caps bound variables (999 on older
    # builds), and real deployments have far more rows than that.
    _CHUNK = 500
    pks = [int(pk) for pk, _ in rows]
    for lo in range(0, len(pks), _CHUNK):
        chunk = pks[lo : lo + _CHUNK]
        q = (
            "SELECT id, key, string_value, int_value, float_value, "
            "bool_value FROM embedding_metadata WHERE id IN "
            f"({','.join('?' * len(chunk))})"
        )
        for pk, key, s, i, f, b in con.execute(q, chunk):
            if s is not None:
                val = s
            elif b is not None and i is None and f is None:
                val = bool(b)
            elif i is not None:
                val = int(i)
            elif f is not None:
                val = float(f)
            else:
                val = None
            metas[int(pk)][key] = val
    out = []
    for pk, emb_id in rows:
        md = metas[int(pk)]
        doc = md.pop(_DOC_KEY, None)
        out.append((str(emb_id), md, doc))
    return out


def read_wal_vectors(
    con: sqlite3.Connection, collection_id: str
) -> Dict[str, np.ndarray]:
    """Replay embeddings_queue (Chroma's sqlite WAL) into {id: vector}.

    Vectors are raw little-endian fp32 blobs (encoding 'FLOAT32').
    Rows whose WAL entries were pruned (chroma>=0.5.6 maintenance) just
    won't appear — callers fall back to --reembed for those."""
    if not _has_table(con, "embeddings_queue"):
        return {}
    cols = _columns(con, "embeddings_queue")
    has_topic = "topic" in cols
    sel = "seq_id, operation, id, vector" + (
        ", encoding" if "encoding" in cols else ", NULL"
    )
    if has_topic:
        rows = con.execute(
            f"SELECT {sel} FROM embeddings_queue WHERE topic LIKE ? "
            "ORDER BY seq_id",
            (f"%{collection_id}%",),
        ).fetchall()
    else:
        rows = con.execute(
            f"SELECT {sel} FROM embeddings_queue ORDER BY seq_id"
        ).fetchall()
    vecs: Dict[str, np.ndarray] = {}
    for _seq, op, emb_id, blob, enc in rows:
        if op == _OP_DELETE:
            vecs.pop(str(emb_id), None)
            continue
        if blob is None:
            continue
        if enc is not None and str(enc).upper() not in (
            "FLOAT32",
            "SCALARENCODING.FLOAT32",
        ):
            raise SystemExit(
                f"unsupported WAL vector encoding {enc!r} for {emb_id}"
            )
        vecs[str(emb_id)] = np.frombuffer(blob, dtype="<f4").copy()
    return vecs


def _reembed(ids: List[str], processed_dir: str, skip_missing: bool, device):
    """Decode static/processed/<id>.png and embed it with the configured
    CLIP tower on ``device``. Returns ({id: vector}, [ids still missing])."""
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.runtime.loader import default_loader

    loader = default_loader()
    paths, have = [], []
    missing: List[str] = []
    for id_ in ids:
        path = os.path.join(processed_dir, f"{id_}.png")
        if not os.path.exists(path):
            missing.append(id_)
            continue
        paths.append(path)
        have.append(id_)
    if missing and not skip_missing:
        raise SystemExit(
            f"{len(missing)} ids have neither a WAL vector nor a "
            f"processed image (first: {missing[:5]}); rerun with "
            "--skip-missing to migrate without them"
        )
    if not have:
        return {}, missing
    images = loader.decode_batch(paths, on_error="raise")
    # the config from the environment HERE, not the embedder module's
    # import-time default: a long-lived process may have imported it first
    emb = ClipEmbedder(config=os.environ.get("IMATCH_CLIP_CONFIG", "vit-b32"), device=device).embed_images(images)
    return dict(zip(have, np.asarray(emb, np.float32))), missing


def migrate(
    chroma_dir: str,
    root: str,
    collection: str,
    data_dir: Optional[str] = None,
    reembed: bool = False,
    skip_missing: bool = False,
    dry_run: bool = False,
    device: DeviceLike = None,
) -> dict:
    """Read the Chroma sqlite under ``chroma_dir`` and write its live rows
    as a snapshot under ``data_dir`` (default ``<root>/index_data``, or
    IMATCH_DATA_DIR). Returns the summary the CLI prints. The store and
    any re-embedding run on ``device``: the card unless the CPU is asked
    for."""
    device = resolve_device(device)
    db_path = os.path.join(chroma_dir, "chroma.sqlite3")
    if not os.path.exists(db_path):
        raise SystemExit(f"no chroma.sqlite3 under {chroma_dir!r}")
    con = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        coll_id, dim = _find_collection(con, collection)
        seg = _metadata_segment(con, coll_id)
        records = read_records(con, seg)
        wal = read_wal_vectors(con, coll_id)
    finally:
        con.close()

    live_ids = [r[0] for r in records]
    vecs = {i: wal[i] for i in live_ids if i in wal}
    need = [i for i in live_ids if i not in vecs]
    missing: List[str] = []
    if need:
        if reembed:
            re_vecs, missing = _reembed(need, os.path.join(root, "static", "processed"), skip_missing, device)
            vecs.update(re_vecs)
        elif skip_missing:
            missing = need
        else:
            raise SystemExit(
                f"{len(need)} of {len(live_ids)} rows have no vector in "
                "the Chroma WAL (pruned?). Rerun with --reembed to "
                "re-encode them from static/processed, or --skip-missing "
                "to drop them."
            )

    keep = [r for r in records if r[0] in vecs]
    if keep:
        dims = {vecs[r[0]].shape[0] for r in keep}
        if len(dims) > 1:
            raise SystemExit(f"inconsistent vector dims in WAL: {dims}")
        dim = dims.pop()
        if dim is None or dim <= 0:
            raise SystemExit("could not determine embedding dimension")

    summary = {
        "collection": collection,
        "rows_live": len(live_ids),
        "rows_migrated": len(keep),
        "vectors_from_wal": sum(1 for r in keep if r[0] in wal),
        "vectors_reembedded": sum(1 for r in keep if r[0] not in wal),
        "rows_dropped": len(missing),
        "dim": dim,
    }
    if dry_run:
        return summary

    if data_dir is None:
        data_dir = os.path.join(root, os.environ.get("IMATCH_DATA_DIR", "index_data"))
    from imatch_tpu_torch.index.store import VectorStore

    if keep:
        store = VectorStore(dim=dim, device=device)
        store.add(
            ids=[r[0] for r in keep],
            embeddings=np.stack([vecs[r[0]] for r in keep]),
            metadatas=[r[1] for r in keep],
            documents=[r[2] for r in keep],
        )
    else:
        store = VectorStore(dim=dim or 768, device=device)
    store.save(data_dir)
    summary["data_dir"] = os.path.abspath(data_dir)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chroma-dir", default="chroma_data", help="the reference's CHROMA_PERSIST_DIR")
    ap.add_argument("--root", default=".", help="deployment root (holds static/ and receives index_data/)")
    ap.add_argument(
        "--collection",
        default=os.environ.get("COLLECTION_NAME", "image-match"),
        help="the reference's COLLECTION_NAME",
    )
    ap.add_argument("--data-dir", default=None, help="snapshot output dir")
    ap.add_argument("--reembed", action="store_true", help="re-embed rows whose vectors were pruned from the WAL")
    ap.add_argument(
        "--skip-missing",
        action="store_true",
        help="drop rows that have neither a WAL vector nor a processed image instead of failing",
    )
    ap.add_argument("--dry-run", action="store_true", help="report counts, write nothing")
    ap.add_argument(
        "--device",
        default=os.environ.get("IMATCH_DEVICE") or None,
        help="where the store and --reembed run (the JAX script's --platform): cuda (default) "
        "or cpu; IMATCH_DEVICE sets the default",
    )
    args = ap.parse_args(argv)

    summary = migrate(
        chroma_dir=args.chroma_dir,
        root=args.root,
        collection=args.collection,
        data_dir=args.data_dir,
        reembed=args.reembed,
        skip_missing=args.skip_missing,
        dry_run=args.dry_run,
        device=args.device,
    )
    print(json.dumps(summary, indent=2))
    if not args.dry_run:
        print(
            "\nDone. Serve with:  cd %s && python -m imatch_tpu_torch\n"
            "static/ and filters.json are used in place; encoded/*.pt "
            "(torch Moondream tensors) do not transfer: they are "
            "re-encoded lazily when a filter backfill needs them." % args.root
        )


if __name__ == "__main__":
    main()
