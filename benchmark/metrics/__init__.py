"""One reader a per-layer metric, found by the metric's name
(metrics/<name>.py): `read(record)` takes what the traced run recorded
(the entry's record: spans, the reduced device trace, launch shapes,
counters) and returns the metric's value, or None when the run holds
nothing to read."""
