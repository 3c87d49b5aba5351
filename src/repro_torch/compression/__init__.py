"""Gradient compression under a contact-time bit budget (see base.py)."""
