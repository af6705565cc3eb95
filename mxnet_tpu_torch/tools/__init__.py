"""Command-line tools of the port, run as ``python -m
mxnet_tpu_torch.tools.<name>``: ``mxfleet`` (the serving fleet's router,
replicas and control verbs), ``mxkv`` (the coordination KV server and
client ops) and ``mxserve`` (the in-process server's HTTP door)."""
