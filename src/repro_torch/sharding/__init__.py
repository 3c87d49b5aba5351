"""Declarative parameter specs and their initialisation."""
