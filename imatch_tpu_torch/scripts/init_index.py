"""Standalone index bootstrap: the reference's init_db.py equivalent.

Port of ``scripts/init_index.py``. The reference ships an idempotent
script that creates its persistent ChromaDB collection before the first
serve; here the persistent artifact is the VectorStore's snapshot
directory. This script creates it (or reads it back) and prints its
state, then makes ``static/{uploads,processed,encoded}``:

    initialized empty index at <dir>        (first run)
    existing index at <dir>: N records      (every later run)
    static dirs ready

Usage: ``python -m imatch_tpu_torch.scripts.init_index [root_dir]
[--device cuda|cpu]``. Env: IMATCH_DATA_DIR (the snapshot directory under
the root, default index_data).

The store is loaded on ``cuda`` unless ``--device cpu`` or
IMATCH_DEVICE=cpu asks for the CPU (the JAX script pins its process to
the CPU).
"""

from __future__ import annotations

import argparse
import os

from imatch_tpu_torch.index.store import VectorStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=".", help="deployment root (receives index_data/ and static/)")
    ap.add_argument(
        "--device",
        default=os.environ.get("IMATCH_DEVICE") or None,
        help="cuda (default) or cpu; IMATCH_DEVICE sets the default",
    )
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    data_dir = os.path.join(root, os.environ.get("IMATCH_DATA_DIR", "index_data"))
    existed = os.path.isdir(data_dir) and os.path.exists(os.path.join(data_dir, "manifest.json"))
    store = VectorStore.load(data_dir, device=args.device)
    if existed:
        print(f"existing index at {data_dir}: {store.count()} records")
    else:
        store.save(data_dir)
        print(f"initialized empty index at {data_dir}")
    for sub in ("static/uploads", "static/processed", "static/encoded"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    print("static dirs ready")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
