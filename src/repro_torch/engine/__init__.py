"""Execution engine of the port: the in-core sequential and batched loops
(``incore``), the out-of-core stream loop (``stream``) with its middleware,
fault vocabulary and scheduler, and the sync policies (``sync``)."""
