"""Ingest and search pipeline over the store and the embedder."""
