"""One module a traffic ``kind``: ``run(harness.Run) -> record``."""
