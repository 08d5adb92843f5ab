"""One rank of a job on several processes (``multihost.launch``).

    python -m combblas_tpu_torch.parallel._rankworker <job.pkl>

The job file names the function (``"package.module:function"`` or
``"path/to/file.py:function"``), its keyword arguments, the device
(``"cuda"``: the card of ``LOCAL_RANK``; ``"cpu"``), the backend and the
collectives' timeout. The rank joins the group through torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), runs the function, pickles its return value to the job's
``out`` path (``{rank}`` filled in) and leaves the group. An exception
exits non-zero, which ends the whole job.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path


def main(argv: list[str]) -> int:
    from combblas_tpu_torch.parallel import multihost

    spec = pickle.loads(Path(argv[1]).read_bytes())
    multihost.init_distributed(backend=spec["backend"],
                               device=None if spec["device"] == "cuda" else spec["device"],
                               timeout_s=spec["timeout_s"])
    try:
        result = multihost.load_job(spec["job"])(**spec["kwargs"])
        out = Path(spec["out"].format(rank=multihost.rank()))
        out.write_bytes(pickle.dumps(result))
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
