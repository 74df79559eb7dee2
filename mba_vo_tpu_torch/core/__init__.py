"""Lie groups, rigid transforms and the continuous-time spline."""
