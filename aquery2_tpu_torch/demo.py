"""Streaming ingest with online retraining of a random forest.

    python -m aquery2_tpu_torch.demo            # on the CUDA card
    python -m aquery2_tpu_torch.demo --device cpu

The port's counterpart of ``demo/run_demo.py`` (the reference's demo/):
three batches of electricity data (``datagen.electricity_csv``) stream
into ``source(x vecdouble, y int64)`` by LOAD COMPLEX DATA; the model
module ``models/irf.py`` is loaded by LOAD MODULE and a forest made by
``newtree``; the procedures ``democq`` (enough rows?) and ``democa``
(``fit_inc`` over the table) are recorded, and the conditional trigger
``c`` runs democa after each batch when democq holds. After each batch
the demo waits for the trigger (``drain``) and prints the forest's
accuracy over ``source`` (``test(x, y)``); the last must be above 0.8,
and no trigger may have logged an error.

Its files (the batches, the procedures' .aqp) go under
``build/aquery2_tpu_torch/demo/`` at the root of the checkout, or under
``base_dir``. ``run`` uses only ``execute``, ``procedures`` and
``triggers.drain``, which the JAX package's session has too.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from aquery2_tpu_torch.utils.datagen import electricity_csv

IRF = Path(__file__).resolve().parent / "models" / "irf.py"
WORK = Path(__file__).resolve().parents[1] / "build" / "aquery2_tpu_torch" \
    / "demo"


def run(db, work: str, irf_path: str = str(IRF), batches: int = 3,
        log=print) -> list[float]:
    """Stream the batches through ``db`` and return the accuracy after
    each."""
    os.makedirs(work, exist_ok=True)
    paths = []
    for i in range(batches):
        p = os.path.join(work, f"electricity{i}.csv")
        electricity_csv(p, n=120, seed=100 + i)
        paths.append(p)

    db.execute("create table source(x vecdouble, y int64);")
    db.execute(f"""LOAD MODULE FROM "{irf_path}" FUNCTIONS (
        newtree(height:int, f:int64, sparse:vecint, forget:double,
                noclasses:int64, e:int) -> bool,
        fit_inc(X:vecvecdouble, y:vecint64) -> bool,
        predict(X:vecvecdouble) -> vecint,
        test(X:vecvecdouble, y:vecint64) -> double
    );""")
    db.execute("create table elec_sparse(v int);")
    db.execute("insert into elec_sparse values (0), (1), (1), (1), (1), "
               "(1), (1);")
    db.execute("select newtree(10, 7, elec_sparse.v, 0.3, 2, 1) "
               "from elec_sparse")

    ps = db.procedures
    ps.start_recording("democq")
    db.execute("select count(*) > 100 from source")
    ps.stop_recording()
    ps.start_recording("democa")
    db.execute("select fit_inc(x, y) from source")
    ps.stop_recording()
    db.execute("create trigger c on source action democa when democq")

    accs = []
    for step, path in enumerate(paths):
        db.execute(f"load complex data infile '{path}' into table source "
                   f"fields terminated by ',' element terminated by ';'")
        if not db.triggers.drain(timeout=60.0):
            raise TimeoutError(f"batch {step}: the trigger did not finish")
        n = db.execute("select count(*) from source").scalar()
        acc = db.execute("select test(x, y) from source").scalar()
        log(f"batch {step}: rows={n} accuracy={acc:.3f}")
        accs.append(acc)
    return accs


def main(argv: list[str] | None = None, base_dir: str | None = None) -> int:
    """``[--device cpu]``: the demo on connect()'s device (the card), or
    the one named; its files under ``base_dir`` (default WORK)."""
    from aquery2_tpu_torch import connect

    argv = sys.argv[1:] if argv is None else list(argv)
    device = argv[1] if argv[:1] == ["--device"] and len(argv) > 1 \
        else "cuda"
    work = base_dir or str(WORK)
    db = connect(device=device, base_dir=work)
    errors = []                 # a trigger's failure is logged, not raised
    log_error = db.log_error
    db.log_error = lambda msg: (errors.append(msg), log_error(msg))
    try:
        accs = run(db, work)
    finally:
        db.close()
    if errors:
        raise RuntimeError(f"the demo's triggers failed: {errors}")
    assert accs[-1] > 0.8, "the online model should fit the stream"
    print("demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
