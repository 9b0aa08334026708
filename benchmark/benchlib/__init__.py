"""The harness: loading a cell, running it, tracing and checking it."""
