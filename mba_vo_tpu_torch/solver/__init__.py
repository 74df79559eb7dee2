"""Levenberg-Marquardt over spline control knots."""
