"""Face and licence-plate detectors."""
