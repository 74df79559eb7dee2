"""Keyframe backend: sliding-window bundle adjustment (Schur complement),
PnP loop closure and pose-graph relaxation behind the tracker."""
