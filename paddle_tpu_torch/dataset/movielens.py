"""MovieLens-1M reader creators (reference python/paddle/dataset/
movielens.py: train/test yield [user_id, gender, age, job, movie_id,
category_ids, title_ids, rating]; plus meta accessors max_user_id etc.).
Synthetic fallback with the same field layout and a learnable
user-genre affinity signal."""

import numpy as np

from . import common

__all__ = [
    "train",
    "test",
    "max_user_id",
    "max_movie_id",
    "max_job_id",
    "age_table",
    "movie_categories",
    "user_info",
    "movie_info",
]

N_USERS = 500
N_MOVIES = 400
N_CATEGORIES = 18
N_JOBS = 21
TITLE_VOCAB = 1000
RATINGS = 6000
age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, self.categories, self.title]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def max_user_id():
    return N_USERS


def max_movie_id():
    return N_MOVIES


def max_job_id():
    return N_JOBS


def movie_categories():
    return ["cat%02d" % i for i in range(N_CATEGORIES)]


def _movies():
    rng = common.synthetic_rng("movielens-movies")
    out = {}
    for mid in range(1, N_MOVIES + 1):
        cats = sorted(
            set(int(c) for c in rng.randint(0, N_CATEGORIES, rng.randint(1, 4)))
        )
        title = [int(t) for t in rng.randint(0, TITLE_VOCAB, rng.randint(1, 6))]
        out[mid] = MovieInfo(mid, cats, title)
    return out


def _users():
    rng = common.synthetic_rng("movielens-users")
    out = {}
    for uid in range(1, N_USERS + 1):
        out[uid] = UserInfo(
            uid,
            "M" if rng.rand() < 0.5 else "F",
            int(rng.randint(0, len(age_table))),
            int(rng.randint(0, N_JOBS)),
        )
    return out


def movie_info():
    return _movies()


def user_info():
    return _users()


def _ratings(tag, n):
    rng = common.synthetic_rng("movielens-" + tag)
    movies = _movies()
    users = _users()
    # learnable signal: each user has a favourite category; rating depends
    # on overlap between it and the movie's categories
    fav = {uid: uid % N_CATEGORIES for uid in users}
    for _ in range(n):
        uid = int(rng.randint(1, N_USERS + 1))
        mid = int(rng.randint(1, N_MOVIES + 1))
        u, m = users[uid], movies[mid]
        base = 4.5 if fav[uid] in m.categories else 2.5
        rating = float(np.clip(round(base + rng.randn() * 0.5), 1, 5))
        yield u.value() + m.value() + [rating]


def train():
    return lambda: _ratings("train", RATINGS)


def test():
    return lambda: _ratings("test", RATINGS // 10)
