"""Process groups, collectives and the data-parallel topology."""
