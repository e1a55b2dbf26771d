"""round.launches_per_round: kernel launches on the card in the traced
window, per round, the harness's one ``cat`` a round among them (memory
copies and sets are not launches)."""


def read(view):
    kernels = view.kernels
    if not kernels or not view.rounds:
        return None
    return len(kernels) / view.rounds
