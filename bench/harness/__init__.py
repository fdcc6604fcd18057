"""The benchmark's harness: finding cells by name, driving their traffic,
reading their traces and deciding ``correct``."""
