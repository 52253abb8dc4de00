"""Serving runtime: cross-request batching for the device engine.

This is the structural win over the reference, which pins one whisper.cpp
state per gRPC stream and serializes every stream on its own mutex
(SURVEY.md §2 'Parallelism & distribution'): here all concurrent streams'
and batch tasks' 30 s windows are packed into one compiled decode program.
"""

from speaksense_tpu.runtime.batcher import BatchedEngine  # noqa: F401
