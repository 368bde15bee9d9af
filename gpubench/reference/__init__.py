"""Plain PyTorch references of the benchmark's query templates.

Nothing here imports the engine under test: each suite's ``tables.py``
regenerates, from frozen copies of the generators' formulas, the columns
its templates read, and each ``<suite>/<template>.py`` answers one
template from them.
"""
