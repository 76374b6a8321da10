"""Runners: one module per kind of job, named by a traffic file's ``runner``."""
