"""One reader per metric: `perfbench/metrics/<name>.py`, or for a name
with a suffix after its first dot (`device_idle.chat`) the reader of its
stem (`device_idle.py`). `read(run)` takes the finished run
(`perfbench.harness.Run`) and returns the number, or None where the run
holds nothing to read; the harness then leaves the metric out."""
