"""Command-line tools of the port, run as ``python -m
mxnet_tpu_torch.tools.<name>``: ``mxfleet`` (the serving fleet's router,
replicas and control verbs), ``mxkv`` (the coordination KV server and
client ops), ``mxserve`` (the in-process server's HTTP door), ``im2rec``
(image lists packed into RecordIO files), ``mxtop`` (the pod report of a
telemetry dir), ``mxtrace`` (a telemetry dir as one Chrome trace) and
``benchdiff`` (the perf-regression gate over a bench trajectory)."""
