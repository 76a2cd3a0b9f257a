"""Labeled LDA model and its estimators."""
