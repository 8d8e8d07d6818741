"""The training worker process (``PENROZ_TRAIN_WORKER=1``; counterpart of
penroz_tpu/models/train_worker.py).

The serving parent (models/model.py ``_train_in_worker_process``) starts
``python -m penroz_tpu_torch.models.train_worker '<json args>'``, so that a
crash in training (a CUDA fault, an out-of-memory kill) ends this process
and never the server.  All state flows through the checkpoint the trainer
writes (every ~10 s and at the end); the parent reads the final status.
The exit code is 0 when the model's status, or for an adapter run the
adapter's, reads ``Trained``, else 1.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

log = logging.getLogger(__name__)


def _watch_parent(parent_pid: int) -> None:
    """Exit when the serving parent dies: a worker left behind would keep
    writing ``Training`` into the checkpoint and race a restarted server's
    orphan sweep."""
    while True:
        if os.getppid() != parent_pid:
            print("train_worker: parent died; exiting", file=sys.stderr,
                  flush=True)
            os._exit(1)
        time.sleep(2.0)


def main(argv: list[str]) -> int:
    args = json.loads(argv[0])
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    logging.basicConfig(level=logging.INFO)
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.utils import checkpoint
    adapter = args.get("adapter")
    try:
        NeuralNetworkModel.train_model_on_device(
            args["model_id"], args["device"], args["dataset_id"],
            args["shard"], args["epochs"], args["batch_size"],
            args["block_size"], args["step_size"], adapter=adapter)
    except Exception:  # noqa: BLE001 — the status in the checkpoint says it
        log.exception("Training failed for model %s", args["model_id"])
    try:
        tree = (checkpoint.peek_adapter_tree(adapter["adapter_id"])
                if adapter is not None
                else checkpoint.peek_tree(args["model_id"]))
    except KeyError:   # no checkpoint was written
        return 1
    status = tree.get("status") or {}
    return 0 if status.get("code") == "Trained" else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
