"""Execution engine of the port: the in-core sequential and batched loops
(``incore``) and the sync policies (``sync``)."""
