"""``python -m aquery2_tpu_torch [--device cpu] [script.a | -c "sql"]``:
the REPL on the CUDA card (the reference's ``python3 prompt.py``,
prompt.py:745-787)."""

from aquery2_tpu_torch.repl.prompt import main

raise SystemExit(main())
