"""Parameter and FLOP counts and the mixed-width planner
(``roofline.analysis``)."""
