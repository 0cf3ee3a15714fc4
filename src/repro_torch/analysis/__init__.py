"""Analysis tools over the port's models and the reference's dry-run records
(port of ``repro.analysis``)."""
