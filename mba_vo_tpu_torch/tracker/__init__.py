"""Per-frame blur-aware tracking: patterns, detection and the tracker."""
