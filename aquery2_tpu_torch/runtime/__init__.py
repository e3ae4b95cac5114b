"""Session services.

  stats.py   per-query phase timers and the route of each FUNCTION call
"""
