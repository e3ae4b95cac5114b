"""User modules callable from SQL (LOAD MODULE).

  modules.py             loading .py and .so modules, calling their
                         functions from the evaluator
  aquery_tpu_module.h    the C ABI a .so module compiles against
  example_module.cpp     mydiv and mulvec, the reference's tests/modules.a
"""
