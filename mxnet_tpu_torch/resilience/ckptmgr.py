"""Preemption-safe checkpoint management: atomic, versioned, pruned.

The port's copy of ``mxnet_tpu/resilience/ckptmgr.py`` with the host
payload format (``payload_format="host"``: one ``.npz`` of the tree,
the JAX package's file layout).  The invariant: **the newest readable
checkpoint is never clobbered or corrupted**.

- every save writes to ``<dir>/tmp.<step>``, is made durable, and only
  then renamed to ``<dir>/step_<NNNNNNNN>`` -- the rename is the commit
  point;
- ``latest_step()`` sees only committed directories;
- keep-last-K pruning (``MXTPU_CKPT_KEEP``) deletes oldest *after* the
  new save commits;
- stale ``tmp.*`` from a previous incarnation is swept on save;
- with ``MXTPU_FLEET_SWAP_ON_COMMIT=1`` a commit publishes the serving
  fleet's versioned-params pointer, which the leader router swaps to.

Several processes: the coordinator is rank 0 of the ``torch.distributed``
group when one is initialised (else the single process); the sweep,
commit rename and pruning run there, fenced by barriers of that group.
The sharded orbax format (``payload_format="orbax"``) comes with the
multi-GPU slice and raises.
"""
from __future__ import annotations

import logging
import os as _os
import re as _re
import shutil as _shutil

from ..base import MXNetError
from . import ckpt_keep

_STEP_FMT = "step_%08d"
_STEP_RE = _re.compile(r"^step_(\d{8})$")
_TMP_RE = _re.compile(r"^tmp\.")

#: the fleet's versioned-params pointer (mirrors serving.fleet, which
#: this layer must not import) — the leader router watches this key
#: when MXTPU_FLEET_SWAP_ON_COMMIT=1 and runs a drainless swap
_SWAP_PTR_KEY = "mxtpu_fleet/params_ptr"


def swap_on_commit():
    """``MXTPU_FLEET_SWAP_ON_COMMIT``: publish every committed
    checkpoint as the serving fleet's params pointer?  Default off."""
    return _os.environ.get("MXTPU_FLEET_SWAP_ON_COMMIT", "").strip() \
        .lower() in ("1", "true", "on", "yes")


def _fsync_dir(path):
    """Make directory entries durable (best-effort on exotic fs)."""
    try:
        fd = _os.open(path, _os.O_RDONLY)
    except OSError:
        return
    try:
        _os.fsync(fd)
    except OSError:
        pass
    finally:
        _os.close(fd)


def _barrier(tag):
    """Fence the ranks of an initialised ``torch.distributed`` group
    around the commit; a no-op in one process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def _emit_ckpt(phase, step, path):
    from .. import observability as obs
    obs.emit("ckpt", step=step, phase=phase, path=path)


class CheckpointManager(object):
    """Versioned checkpoints for one training run under ``directory``.

    Parameters
    ----------
    directory : str
        Root directory; committed checkpoints live at
        ``directory/step_<NNNNNNNN>``.
    keep : int, optional
        Checkpoints retained (keep-last-K); defaults to
        ``MXTPU_CKPT_KEEP`` (3).  ``keep <= 0`` disables pruning.
    payload_format : str, optional
        ``"host"``: the replicated-host writer (``host_save``) -- rank 0
        writes the whole tree.  ``"orbax"`` (the JAX package's default,
        coordinated sharded writes) raises :class:`MXNetError`: it comes
        with the multi-GPU slice (``ROADMAP.md`` queue 1 item 3).
    """

    def __init__(self, directory, keep=None, logger=None,
                 payload_format="host"):
        if payload_format == "orbax":
            raise MXNetError(
                "CheckpointManager(payload_format='orbax'): sharded "
                "checkpoints are not ported yet; they come with the "
                "multi-GPU slice (ROADMAP.md queue 1 item 3). Use "
                "payload_format='host'")
        if payload_format != "host":
            raise ValueError("payload_format must be 'orbax' or 'host', "
                             "got %r" % (payload_format,))
        self.directory = _os.path.abspath(str(directory))
        self.keep = ckpt_keep() if keep is None else int(keep)
        self.payload_format = payload_format
        self.logger = logger or logging

    # ------------------------------------------------------------------
    # discovery
    # ------------------------------------------------------------------
    def step_path(self, step):
        return _os.path.join(self.directory, _STEP_FMT % int(step))

    def all_steps(self):
        """Sorted committed steps (tmp/partial writes are invisible)."""
        try:
            names = _os.listdir(self.directory)
        except OSError:
            return []
        steps = []
        for name in names:
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self):
        """Newest committed step, or None when the run is fresh."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    # save / restore
    # ------------------------------------------------------------------
    def save(self, tree, step):
        """Atomically commit ``tree`` as the checkpoint for ``step``.

        Every process must call this; blocks until the checkpoint is
        durable AND committed.  Returns the committed path.
        """
        from ..parallel.ckpt import host_save, is_coordinator
        from .faultinject import maybe_fault
        from ..observability import spans as _spans
        step = int(step)
        final = self.step_path(step)
        if _os.path.isdir(final):
            raise ValueError("checkpoint for step %d already exists at %s"
                             % (step, final))
        _emit_ckpt("save_begin", step, final)
        with _spans.span("ckpt_save", step=step):
            _os.makedirs(self.directory, exist_ok=True)
            # sweep stale scratch on the coordinator only, fenced BEFORE
            # any rank starts writing: an unfenced every-rank sweep on
            # shared storage lets a late-arriving rank rmtree a peer's
            # in-progress tmp of the current round
            if is_coordinator():
                self._sweep_tmp(current_step=step)
            _barrier("mxtpu_ckpt_sweep_%d" % step)
            maybe_fault("ckpt_write", step=step)
            # pid-free scratch name, identical on every rank
            tmp = _os.path.join(self.directory, "tmp.%d" % step)
            host_save(tmp, tree, step)
            maybe_fault("ckpt_commit", step=step)
            _barrier("mxtpu_ckpt_commit_%d" % step)
            if is_coordinator():
                _os.rename(tmp, final)               # the commit point
                _fsync_dir(self.directory)
                self.prune()
            _barrier("mxtpu_ckpt_done_%d" % step)
        _emit_ckpt("commit", step, final)
        if is_coordinator() and swap_on_commit():
            self._publish_swap_pointer(step, final)
        self.logger.info("checkpoint committed: %s", final)
        return final

    def _publish_swap_pointer(self, step, path):
        """``MXTPU_FLEET_SWAP_ON_COMMIT=1``: publish the committed
        checkpoint as the fleet's versioned-params pointer
        (coordinator only, best-effort — a dead coordination plane
        must not turn a durable save into a crash).  The leader router
        watches the key and runs a drainless hot-swap against it."""
        import json
        try:
            from .netkv import connect_kv
            root = _os.environ.get("MXTPU_FLEET_DIR") or \
                _os.path.join(_os.getcwd(), "mxtpu_fleet")
            kv = connect_kv(default_root=_os.path.join(root, "kv"))
            try:
                kv.key_value_set(_SWAP_PTR_KEY, json.dumps(
                    {"params": path, "version": _STEP_FMT % int(step),
                     "step": int(step)}, sort_keys=True))
            finally:
                kv.close()
            _emit_ckpt("swap_pointer", step, path)
        except Exception as exc:  # noqa: BLE001 - best-effort publish
            self.logger.warning(
                "swap-on-commit pointer publish failed for step %d "
                "(%s); the fleet keeps serving the old version",
                step, exc)

    def restore(self, abstract_tree, step=None):
        """Restore ``step`` (default: latest committed).

        Returns ``(tree, step)``; raises if nothing is committed, and
        raises a structured :class:`~mxnet_tpu_torch.resilience
        .ResilienceError` (kind=``restore_mismatch``) naming every
        disagreeing leaf when the target's shapes/dtypes or tree
        structure do not match the saved checkpoint (checked BEFORE the
        restore, so a mis-wired resume never gets the saved shapes
        back silently).
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    "no committed checkpoint under %s" % self.directory)
        from ..parallel.ckpt import (describe_restore_mismatch,
                                     host_restore, is_host_format)
        path = self.step_path(step)
        mismatches = describe_restore_mismatch(path, abstract_tree)
        if mismatches:
            from . import ResilienceError
            detail = "; ".join(
                "%s: checkpoint has %s, restore target wants %s"
                % (leaf, saved, want)
                for leaf, saved, want in mismatches[:8])
            if len(mismatches) > 8:
                detail += "; ... %d more" % (len(mismatches) - 8)
            raise ResilienceError(
                "checkpoint %s does not match the restore target "
                "(%d leaf mismatch%s): %s"
                % (path, len(mismatches),
                   "" if len(mismatches) == 1 else "es", detail),
                phase="ckpt_restore", step=step, kind="restore_mismatch")
        if not is_host_format(path):
            raise MXNetError(
                "checkpoint %s is not in the host format; sharded "
                "checkpoints come with the multi-GPU slice" % path)
        tree, saved_step = host_restore(path, abstract_tree)
        _emit_ckpt("resume", saved_step, path)
        return tree, saved_step

    def auto_resume(self, abstract_tree):
        """``(tree, step)`` from the newest *readable* committed
        checkpoint, or None when the run is fresh — the one-liner a
        preemptible training script puts before its loop.

        A committed checkpoint can still be damaged after the fact
        (storage loss, an operator's stray truncation, bit rot); the
        commit protocol only guarantees no checkpoint is *born*
        half-written.  So restore failures walk back through the kept
        versions, newest first, emitting a ``restore_corrupt_skip``
        ckpt event per bad one; only when every kept version is bad
        does this raise :class:`ResilienceError`
        (kind=``restore_corrupt``).  A ``restore_mismatch`` propagates
        immediately instead: a target-shape disagreement is a mis-wired
        resume, and every older version would "mismatch" the same way —
        walking back would bury the real diagnosis under a misleading
        corruption report.
        """
        steps = self.all_steps()
        if not steps:
            return None
        from . import ResilienceError
        failures = []
        for step in reversed(steps):
            try:
                return self.restore(abstract_tree, step=step)
            except ResilienceError:
                raise
            except Exception as exc:  # noqa: BLE001 - any read tear
                failures.append((step, exc))
                self.logger.warning(
                    "checkpoint step %d unreadable (%s); trying the "
                    "previous kept version", step, exc)
                _emit_ckpt("restore_corrupt_skip", step,
                           self.step_path(step))
        raise ResilienceError(
            "all %d kept checkpoints under %s are unreadable (%s)"
            % (len(failures), self.directory,
               "; ".join("step %d: %r" % (s, e) for s, e in failures)),
            phase="ckpt_restore", step=steps[-1], kind="restore_corrupt")

    # ------------------------------------------------------------------
    # hygiene
    # ------------------------------------------------------------------
    def prune(self):
        """Delete committed checkpoints beyond keep-last-K."""
        if self.keep <= 0:
            return
        steps = self.all_steps()
        for step in steps[:-self.keep]:
            path = self.step_path(step)
            try:
                _shutil.rmtree(path)
                self.logger.info("checkpoint pruned: %s", path)
            except OSError:
                self.logger.warning("could not prune %s", path)

    def _sweep_tmp(self, current_step=None):
        """Remove tmp leftovers from crashed predecessors (they are by
        definition uncommitted; a restart never resumes a tmp).  The
        current round's own scratch (``tmp.<current_step>``) is spared
        so a sweep can never eat the save that triggered it."""
        spare = None if current_step is None \
            else "tmp.%d" % int(current_step)
        try:
            names = _os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if _TMP_RE.match(name) and name != spare:
                try:
                    _shutil.rmtree(_os.path.join(self.directory, name))
                except OSError:
                    pass


# ----------------------------------------------------------------------
# classic prefix-NNNN.params checkpoints (model.save_checkpoint format)
# ----------------------------------------------------------------------
def latest_classic_epoch(prefix):
    """Newest epoch N for which ``prefix-%04d.params`` exists, or None:
    the discovery half of ``FeedForward.fit(resume="auto")`` and
    ``Module.load_latest`` for the reference's 0x112 checkpoints (one
    file per epoch)."""
    directory, base = _os.path.split(_os.path.abspath(str(prefix)))
    pat = _re.compile(r"^%s-(\d{4})\.params$" % _re.escape(base))
    try:
        names = _os.listdir(directory or ".")
    except OSError:
        return None
    epochs = [int(m.group(1)) for m in map(pat.match, names) if m]
    return max(epochs) if epochs else None
