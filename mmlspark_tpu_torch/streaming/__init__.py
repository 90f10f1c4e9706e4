"""Micro-batch streaming engine — the port's copy of
``mmlspark_tpu/streaming/`` (Spark Structured Streaming + Spark Serving
ingestion), with the reference's public names and on-disk checkpoint
layout.

Continuous ingest → incremental fit on the card → durable model commit →
hot serving:

    source = FileStreamSource("/data/incoming", pattern="part-*.npz")
    sink = ModelCommitSink(lambda: LightGBMClassifier(numIterations=10))
    with StreamingQuery(source, sink, trigger=AvailableNow()) as query:
        query.await_termination()

The engine is host code; each epoch's fit runs where its estimator's
``device`` says (the card by default). Importing this package loads
neither ``jax`` nor ``mmlspark_tpu``.
"""

from mmlspark_tpu_torch.streaming.query import (
    AvailableNow,
    Once,
    ProcessingTime,
    StreamingQuery,
    Trigger,
)
from mmlspark_tpu_torch.streaming.sink import (
    ForeachBatchSink,
    MemorySink,
    ModelCommitSink,
    Sink,
)
from mmlspark_tpu_torch.streaming.source import (
    FileStreamSource,
    MemoryStream,
    StreamSource,
)

__all__ = [
    "AvailableNow",
    "FileStreamSource",
    "ForeachBatchSink",
    "MemorySink",
    "MemoryStream",
    "ModelCommitSink",
    "Once",
    "ProcessingTime",
    "Sink",
    "StreamSource",
    "StreamingQuery",
    "Trigger",
]
