"""Parameter-server role entry point (compatibility shim).

The port of ``mxnet_tpu/kvstore_server.py`` (the reference's
``python/mxnet/kvstore_server.py``).  In the reference a process launched
with ``DMLC_ROLE=server`` (or ``scheduler``) never returns from ``import
mxnet``: it creates a dist kvstore, installs the controller (which
unpickles the optimizer the workers send as command 0) and blocks in
the server loop.  The port has no parameter servers: a dist store sums
the gradients over the workers with a collective and every worker runs
the update (``kvstore.py``).  The shim keeps the process contract: a
server- or scheduler-role process parks and exits 0 instead of
training, and joins no process group (the group is the workers').
"""
from __future__ import annotations

import logging
import os
import pickle
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer(object):
    """Parity: kvstore_server.py:14 KVStoreServer."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.handle = getattr(kvstore, "handle", None)
        self.init_logging()

    def init_logging(self):
        self.logger = logging.getLogger("mxnet_tpu_torch.kvstore_server")

    def _controller(self):
        """Command handler (head 0 = pickled optimizer)."""
        def server_controller(cmd_id, cmd_body):
            if cmd_id == 0:
                self.kvstore.set_optimizer(pickle.loads(cmd_body))
            else:
                self.logger.info("server command %d ignored (no parameter "
                                 "server)", cmd_id)
        return server_controller

    def run(self):
        """In the reference: blocks in the server loop.  Here there is
        no server work: log and return."""
        self.logger.info(
            "kvstore server role is a no-op: the workers sum their "
            "gradients with a collective and each runs the update")


def _init_kvstore_server_module():
    """Parity kvstore_server.py:58-68: park server/scheduler processes."""
    role = os.environ.get("DMLC_ROLE", "worker")
    if role in ("server", "scheduler"):
        from . import kvstore
        KVStoreServer(kvstore.KVStore("dist_sync")).run()
        sys.exit(0)
