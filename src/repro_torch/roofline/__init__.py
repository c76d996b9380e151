"""Roofline (port of ``repro/roofline``): the H100's ceilings
(:mod:`.hw`), each kernel's bytes and operations and the LM's analytic
step model (:mod:`.analysis`), the query pipeline's per-stage report
(:mod:`.pipeline`) and the dry-run tables (:mod:`.report`)."""
