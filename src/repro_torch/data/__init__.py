"""Seeded synthetic data: graphs, program-analysis facts and the recsys
click stream (numpy only)."""
