"""RANSAC trials a search second: the trials of every pair
(``n_trials``) over the calls' search seconds, in the window."""

LAYER = "anytime loop"
UNIT = "trials/s"
MOVES = "pose_p90_s"


def read(rec):
    search = sum(c["search_s"] for c in rec["calls"])
    trials = sum(c["trials"] for c in rec["calls"])
    return trials / search if search > 0 and trials > 0 else None
