"""Synthetic scenes and the motion-blur forward model."""
