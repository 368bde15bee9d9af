"""The benchmark's general code: it reads every cell-specific piece
(configuration, traffic mix, templates, references, metric readers) from
files found by name."""
