"""One general driver a system: ``drivers/<system>.py`` serves every
configuration whose ``system`` names it, and every traffic mix of it.  A
driver's ``run(cell, t0)`` sets up, measures the window, checks what the
window produced against the plain reference and returns a
:class:`~portbench.harness.Outcome`."""
