"""Dataset generators (port of ``repro/data``)."""
