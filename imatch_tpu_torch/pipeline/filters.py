"""Natural-language yes/no filter subsystem (a copy of
imatch_tpu/pipeline/filters.py).

As in the reference app, filters are a list of strings persisted in
filters.json; each image's per-filter answers live as a JSON string under
``filter_results_json`` in its metadata; a background back-fill applies a
new filter to every image with a progress dict; search results are
post-filtered to those answering "yes" to every selected filter.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

logger = logging.getLogger("imatch.filters")


def load_filters(filters_file: str) -> List[str]:
    if os.path.exists(filters_file):
        try:
            with open(filters_file, "r", encoding="utf-8") as f:
                return json.load(f)
        except Exception as e:  # corrupted file -> degraded empty list
            logger.error("error loading filters: %s", e)
    return []


def save_filters(filters_file: str, filters: List[str]) -> None:
    os.makedirs(os.path.dirname(filters_file) or ".", exist_ok=True)
    # tmp + rename: a truncate-write in place would let a concurrent
    # load_filters (or a crash mid-write) observe partial JSON, degrade
    # to [], and have the next save wipe every existing filter.
    tmp = filters_file + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(filters, f)
    os.replace(tmp, filters_file)


def format_filter_query(filter_query: str) -> str:
    """'Yes or No: <q>' unless already formatted."""
    lower = filter_query.lower()
    if "yes or no:" in lower or "yes/no:" in lower:
        return filter_query
    return f"Yes or No: {filter_query}"


def format_filter_for_display(filter_query: str) -> str:
    lower = filter_query.lower()
    if lower.startswith("yes or no:"):
        return filter_query[len("yes or no:") :].strip()
    if lower.startswith("yes/no:"):
        return filter_query[len("yes/no:") :].strip()
    return filter_query


def passes_filters(metadata: dict, selected: List[str]) -> bool:
    """AND-semantics post-filter: every selected filter answered 'yes'."""
    if not selected:
        return True
    raw = metadata.get("filter_results_json")
    if not raw:
        return False
    try:
        results = json.loads(raw)
    except Exception:
        return False
    for f in selected:
        ans = results.get(f)
        if not isinstance(ans, str) or ans.strip().lower() != "yes":
            return False
    return True


def merge_filter_result(metadata: dict, filter_query: str, answer: str) -> dict:
    results: Dict[str, str] = {}
    raw = metadata.get("filter_results_json")
    if raw:
        try:
            results = json.loads(raw)
        except Exception:
            logger.error("error parsing existing filter results")
    results[filter_query] = answer
    metadata["filter_results_json"] = json.dumps(results)
    return metadata
