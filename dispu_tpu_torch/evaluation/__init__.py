"""Point-cloud file I/O (counterpart of ``evaluation/``; the metrics and
the report are not ported yet)."""
