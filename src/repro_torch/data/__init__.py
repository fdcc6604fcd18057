"""Seeded synthetic EDBs: graphs and program-analysis facts (numpy only)."""
