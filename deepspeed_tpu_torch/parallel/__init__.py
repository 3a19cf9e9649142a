"""Process groups, collectives, point-to-point sends and the process
topology (pipe x data, with its groups)."""
