"""References of the TPC-H templates."""
