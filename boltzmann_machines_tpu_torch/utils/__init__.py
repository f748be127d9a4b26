from .rng import RNG
from .stopwatch import Stopwatch
from .utils import (batch_iter, epoch_iter, make_list_from, schedule_value,
                    one_hot, one_hot_decision_function, unhot,
                    log_sum_exp, log_mean_exp, log_diff_exp, log_std_exp,
                    write_during_training)
